"""No module under vgbench/ imports JAX or the JAX package, comparing whole
top-level names (the port's name begins with the JAX package's), and the
reference imports nothing of the port."""

from __future__ import annotations

import ast
import os

from vgbench import spec

JAX = {"jax", "jaxlib", "flax", "varigraph_tpu"}


def _imports(path: str) -> set[str]:
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _files(sub: str = "") -> list[str]:
    return spec.tree_files(os.path.join(spec.BENCH_DIR, sub), (".py",))


def test_nothing_under_vgbench_imports_jax_or_the_jax_package():
    files = _files()
    assert len(files) > 10
    for f in files:
        assert not (_imports(f) & JAX), f


def test_the_reference_imports_nothing_of_the_port():
    for f in _files("reference"):
        assert "varigraph_tpu_torch" not in _imports(f), f
        assert not (_imports(f) & JAX), f


def test_whole_names_are_compared():
    assert "varigraph_tpu_torch" not in JAX
    assert {"varigraph_tpu_torch"} & JAX == set()
