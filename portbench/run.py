"""The benchmark's command: run one cell once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The program (``src/repro_torch``) and
the benchmark are put on the path here; every cache of the program lies
inside the checkout, Python's bytecode too: an interpreter that is told
not to write bytecode (``PYTHONDONTWRITEBYTECODE``) would otherwise
compile torch's sources again in every run, some 10 s of set-up that
swings with the host's load.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"

if __name__ == "__main__":
    sys.pycache_prefix = str(CACHE / "pyc")
    sys.dont_write_bytecode = False
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], T0))
