"""Share of the mag-2 voxels pooled in the stretch that the card pooled: the voxels of the dense.pool spans over those and the host's mean pooling (chunk.downsample spans at mag 2, mode mean; a stride view pools nothing), in %. Nothing where neither span carries a voxel count (a program without them)."""

from perfbench.lib import program_spans


def read(ctx):
    recs = program_spans.in_stretch(ctx)
    if recs is None:
        return None
    card = [r["attrs"]["voxels"] for r in recs if r["name"] == "dense.pool"]
    host = [r["attrs"]["voxels"] for r in recs if r["name"] == "chunk.downsample"
            and r["attrs"].get("mag") == 2 and r["attrs"].get("mode") == "mean"
            and "voxels" in r["attrs"]]
    total = sum(card) + sum(host)
    if not total:
        return None
    return 100.0 * sum(card) / total
