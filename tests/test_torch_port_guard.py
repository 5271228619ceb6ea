"""The port stands alone: nothing under ``src/repro_torch`` imports JAX or
the JAX package (not even its modules that do not import JAX), and the
serving and training paths run in a process where ``jax`` never loads."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PY_FILES = sorted(PORT.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax") or top == "repro"


def test_port_has_files():
    assert len(PY_FILES) >= 15
    assert (PORT / "kernels" / "csrc" / "zen_infer.cu").exists()
    assert (PORT / "kernels" / "csrc" / "zen_train.cu").exists()
    assert (PORT / "kernels" / "csrc" / "sparse_row.cu").exists()
    assert (PORT / "kernels" / "csrc" / "cdf_search.cu").exists()
    assert (PORT / "kernels" / "csrc" / "topic_histogram.cu").exists()


@pytest.mark.parametrize("path", PY_FILES,
                         ids=lambda p: str(p.relative_to(PORT)))
def test_no_jax_or_reference_imports(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_chip_smoke_imports_no_jax():
    bad = [n for n in _imports(ROOT / "chip_smoke.py") if _forbidden(n)]
    assert not bad


def test_serving_path_runs_without_jax_loaded():
    code = (
        "import sys, numpy as np\n"
        "import repro_torch.launch.serve_lda\n"
        "from repro_torch.serving import FrozenLDAModel, LDAEngine, "
        "LDAServeConfig\n"
        "from repro_torch.train.checkpoint import load_lda_model\n"
        "n = np.eye(4, dtype=np.int32).repeat(3, 0) * 50\n"
        "m = FrozenLDAModel.from_numpy(n, n.sum(0), {'num_topics': 4}, "
        "device='cpu')\n"
        "for mode in ('throughput', 'latency'):\n"
        "    e = LDAEngine(m, LDAServeConfig(buckets=(8,), mode=mode, "
        "algorithm='zen_pallas'))\n"
        "    assert e.infer_batch([[0, 1, 2], [3, 4]]).shape == (2, 4)\n"
        "import repro_torch.launch.train\n"
        "from repro_torch.data.corpus import synthetic_corpus\n"
        "from repro_torch.core.types import LDAHyperParams\n"
        "from repro_torch.train.session import RunConfig, TrainSession\n"
        "c = synthetic_corpus(0, num_docs=6, num_words=10, avg_doc_len=5)\n"
        "for alg in ('zen', 'std', 'zen_pallas', 'zen_sparse', 'sparselda', "
        "'zen_hybrid', 'lightlda', 'zen_cdf'):\n"
        "    s = TrainSession(c, LDAHyperParams(num_topics=3), RunConfig("
        "algorithm=alg, num_iterations=2, eval_every=1), device='cpu')\n"
        "    st = s.run(0)\n"
        "    st.check_invariants(s.corpus)\n"
        "    assert st.iteration == 2 and s.perplexity(st) > 1\n"
        "loaded = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not loaded, loaded\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
