"""Nothing the benchmark imports, directly or through the program, loads
JAX or the JAX package; the reference imports nothing of the program.

The walk is static (``ast``): from every module under ``perfbench/`` through
every module of this repository that it imports, at any depth, including
imports inside functions. Names are compared whole by their top level, so
``syconn_tpu_torch`` is not ``syconn_tpu``.
"""

import ast
import os

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "syconn_tpu"}
LOCAL = ("perfbench", "syconn_tpu_torch")


def _file_of(root, module):
    base = os.path.join(root, *module.split("."))
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(cand):
            return cand
    return None


def _module_of(root, path):
    rel = os.path.relpath(path, root)[:-3].split(os.sep)
    if rel[-1] == "__init__":
        rel = rel[:-1]
    return ".".join(rel)


def _imports(root, path):
    """Absolute names of every module ``path`` imports."""
    mod = _module_of(root, path)
    pkg = mod if path.endswith("__init__.py") else mod.rpartition(".")[0]
    out = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = pkg.split(".")
                base = ".".join(parts[:len(parts) - node.level + 1])
                name = f"{base}.{node.module}" if node.module else base
            else:
                name = node.module
            out.add(name)
            out.update(f"{name}.{a.name}" for a in node.names)
    return out


def _walk(root, start_files):
    seen, todo, edges = set(), list(start_files), []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(root, path):
            edges.append((path, name))
            if name.split(".")[0] in LOCAL:
                f = _file_of(root, name)
                if f is not None:
                    todo.append(f)
    return seen, edges


def _bench_files(root, sub=""):
    top = os.path.join(root, "perfbench", sub)
    return [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs if f.endswith(".py")]


def test_no_jax_anywhere_the_benchmark_reaches(root):
    seen, edges = _walk(root, _bench_files(root))
    bad = sorted({(os.path.relpath(p, root), n) for p, n in edges if n.split(".")[0] in FORBIDDEN})
    assert not bad, bad
    # the walk did reach the program's dense path
    reached = {os.path.relpath(p, root) for p in seen}
    assert {"syconn_tpu_torch/inference/dense.py", "syconn_tpu_torch/ops/conv3d.py",
            "syconn_tpu_torch/io/chunked.py"} <= reached


def test_reference_imports_nothing_of_the_program(root):
    seen, edges = _walk(root, _bench_files(root, "reference"))
    assert not [n for _, n in edges if n.split(".")[0] in FORBIDDEN | {"syconn_tpu_torch"}]
    assert all(os.path.relpath(p, root).startswith("perfbench") for p in seen)


def test_whole_name_comparison():
    assert "syconn_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "syconn_tpu.models".split(".")[0] in FORBIDDEN
