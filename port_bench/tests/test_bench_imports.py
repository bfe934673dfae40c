"""Nothing under port_bench imports JAX or the JAX package (the top-level
name compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import os

import pytest

from port_bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "deepvision_tpu"}


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, names in os.walk(os.path.join(harness.BENCH_DIR, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


@pytest.mark.parametrize("path", sorted(_sources()))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")))
def test_reference_is_plain(path):
    assert not set(_imports(path)) & (FORBIDDEN | {"deepvision_tpu_torch",
                                                   "port_bench"})
