"""The port's surface covers the JAX package's, module by module.

For every module of ``src/repro/`` (read by AST: neither package is
imported), the module of the same path under ``src/repro_torch/`` exists
and has every public top-level name the reference's has: functions,
classes, assigned names, and names imported from the package itself (its
re-exports). Names imported from outside the package (jax, numpy, typing,
the standard library) are not the package's surface. The exemptions below
are JAX-only, each with its reason; an exemption that no longer exempts
anything fails too, so the list stays exact.
"""
import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

MODULES_EXEMPT = {
    "utils/compat.py": "JAX version shims (jax.sharding, shard_map, the "
                       "Pallas TPU compiler options); the port needs none",
}

# (rule, reason): a name the rule matches is exempt in every module
RULES = [
    (lambda mod, name: name.endswith("_pallas"),
     "a Pallas TPU kernel entry; the port's kernel is hand-written CUDA "
     "behind the same ops wrapper"),
    (lambda mod, name: name == "pallas_tpu_compiler_params",
     "the Pallas TPU compiler options that utils/compat.py builds"),
    (lambda mod, name: name == "compat",
     "the JAX version-shim module (utils/compat.py), re-imported"),
    (lambda mod, name: mod.startswith("models/") and name.startswith("init_"),
     "a functional initialiser of the JAX parameter pytree; the port builds "
     "nn.Modules (models/) and converts reference trees (models/convert.py)"),
]

NAMES = {
    ("core/distributed.py", "make_dist_step"):
        "builds a jit(shard_map) step over a jax Mesh; a port rank runs "
        "distributed.dist_step eagerly under torch.distributed",
    ("core/distributed.py", "make_dist_llh"):
        "builds a jit(shard_map) likelihood over a jax Mesh; a port rank "
        "runs distributed.dist_llh",
    ("core/distributed.py", "make_rebuild_counts"):
        "builds a jit(shard_map) count rebuild over a jax Mesh; a port rank "
        "runs distributed.rebuild_counts",
    ("core/distributed.py", "state_shardings"):
        "the jax NamedShardings of the mesh state; a port rank holds only "
        "its own cell",
    ("kernels/topic_histogram.py", "tile_ranks"):
        "the Pallas histogram's rank slots per token tile (its MXU one-hot "
        "layout); kernel 5 walks sorted runs and needs none",
    ("launch/roofline.py", "collective_bytes_from_text"):
        "parses XLA's HLO text; the port counts collectives by tracing the "
        "step (roofline.collective_bytes)",
    ("models/transformer.py", "scan_or_unroll"):
        "jax.lax.scan over stacked layer pytrees; the port loops over its "
        "nn.Module layers",
    ("models/transformer.py", "PatternedStacks"):
        "the functional pytree of stacked local and global layers; the "
        "port holds them as nn.Module lists",
}


def _targets(node):
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _targets(elt)


def public_names(path: pathlib.Path, package: str) -> set:
    """Public top-level names of a module: defs, classes, assigned names and
    names imported from ``package`` itself (or relatively)."""
    out = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out.add(node.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    out.update(_targets(t))
            elif isinstance(node, ast.AnnAssign):
                out.update(_targets(node.target))
            elif isinstance(node, ast.ImportFrom):
                if node.level or (node.module or "").split(".")[0] == package:
                    out.update(a.asname or a.name for a in node.names)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
                for h in node.handlers:
                    visit(h.body)

    visit(ast.parse(path.read_text()).body)
    return {n for n in out if not n.startswith("_")}


def exempt(mod: str, name: str) -> bool:
    return (mod, name) in NAMES or any(rule(mod, name) for rule, _ in RULES)


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def missing(mod: str) -> set:
    ref = public_names(REF / mod, "repro")
    port = public_names(PORT / mod, "repro_torch")
    return ref - port


@pytest.mark.parametrize("mod", MODULES)
def test_port_module_has_the_reference_surface(mod):
    if mod in MODULES_EXEMPT:
        assert not (PORT / mod).exists(), f"{mod} is ported: drop it from "\
            f"MODULES_EXEMPT"
        return
    assert (PORT / mod).exists(), f"no counterpart of src/repro/{mod}"
    gaps = sorted(n for n in missing(mod) if not exempt(mod, n))
    assert not gaps, f"src/repro_torch/{mod} lacks {gaps}"


def test_every_exemption_exempts_something():
    used = set()
    for mod in MODULES:
        if mod in MODULES_EXEMPT:
            continue
        for name in missing(mod):
            if (mod, name) in NAMES:
                used.add((mod, name))
    assert used == set(NAMES), sorted(set(NAMES) - used)
    for mod in MODULES_EXEMPT:
        assert mod in MODULES and not (PORT / mod).exists(), mod


def test_only_the_exempt_modules_lack_a_counterpart():
    lacking = [m for m in MODULES if not (PORT / m).exists()]
    assert lacking == sorted(MODULES_EXEMPT)


def test_the_reasons_are_stated():
    reasons = list(NAMES.values()) + [r for _, r in RULES] + \
        list(MODULES_EXEMPT.values())
    assert all(len(r.split()) >= 6 for r in reasons)
