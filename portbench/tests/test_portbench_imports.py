"""What the benchmark may import: nothing under ``portbench/`` imports a
module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` (whole names: ``repro_torch`` is not ``repro``), and
the reference imports nothing of the program."""
import ast
import pathlib

import pytest

from portbench import harness, registry

FILES = sorted(registry.HERE.rglob("*.py"))
REFERENCE = registry.HERE / "reference"


def imported(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(registry.HERE)))
def test_no_jax_and_reference_apart(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & set(harness.FORBIDDEN), tops
    if REFERENCE in path.parents:
        assert "repro_torch" not in tops, tops


def test_forbidden_modules_by_whole_top_level_name():
    mods = ["repro_torch", "repro_torch.core", "reprox", "jaxtyping",
            "repro", "repro.core", "jax.numpy", "flax", "jaxlib.xla"]
    assert harness.forbidden_modules(mods) == [
        "flax", "jax.numpy", "jaxlib.xla", "repro", "repro.core"]
