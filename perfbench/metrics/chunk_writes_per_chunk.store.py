"""Chunk files written (chunk.write spans) per distinct chunk written in the stretch: 1 when each chunk is written once."""

from perfbench.lib import program_spans


def read(ctx):
    return program_spans.writes_per_chunk(ctx)
