"""Build the CUDA sources with nvcc and bind them by ctypes.

Each source in :data:`SOURCES` compiles to a shared library with a plain C
interface, named by a hash of its source and flags, into ``build/`` beside
this file (listed in ``.gitignore``). The sources not built yet compile
in parallel, one nvcc each; a library already built from the same source
and flags is reused. Nothing here runs at import: the first launch builds
and loads.

Each kernel has one block shape, a constant of its source. A measurement
can rebuild a source with ``-D`` another shape and run the launchers on it
for a while (:func:`variant`); nothing else does.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import types
from typing import Iterable, Optional, Sequence, Tuple

_HERE = pathlib.Path(__file__).resolve().parent
SOURCES = (
    _HERE / "csrc" / "zen_infer.cu",  # serving: queue-2 kernels 3 and 4
    _HERE / "csrc" / "zen_train.cu",  # training: queue-2 kernels 1 and 2
    _HERE / "csrc" / "sparse_row.cu",  # padded-sparse rows: kernel 6
    _HERE / "csrc" / "cdf_search.cu",  # zen_cdf's CDF row search: kernel 7
    _HERE / "csrc" / "topic_histogram.cu",  # delta histogram: kernel 5
)
BUILD_DIR = _HERE / "build"

# -fmad=false: no multiply-add contraction, so every float op rounds as
# its plain torch version does; no --use_fast_math (approximate logf and
# division would break parity with the reference)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of the sources' extern "C" launchers
SIGNATURES = {
    "zen_infer_gathered": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P,
                           _P, _P),
    "zen_infer_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _F, _F, _P, _P, _P),
    # the serving exact loop alone (test-only: the draws to keep)
    "zen_infer_exact": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _F, _F, _P),
    # where the serving table goes, the estimate's margin and its
    # exhaustive check (test-only)
    "zen_infer_global_table": (_I, _P),
    "zen_infer_constants": (_P, _P),
    "zen_infer_fast_error": (_P, _I, _I, _P, _P),
    # ..., seed, row0, token_index (null: row0 + t), beta, w_beta, ...
    "zen_train_gathered": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _F,
                           _F, _P, _P, _P),
    "zen_train_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _P, _F, _F, _P, _P, _P),
    # where the training table goes: the global scratch a launch needs
    "zen_train_global_table": (_I, _P),
    # the training estimate's margin and its exhaustive check (test-only)
    "zen_train_constants": (_P, _P),
    "zen_train_fast_error": (_P, _I, _I, _P, _P),
    "sparse_row": (_P, _P, _P, _P, _I, _I, _P),
    "cdf_search": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "topic_histogram": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # the histogram launch's shape: its topic slab, and runs per warp
    "topic_histogram_shape": (_I, _P, _P),
}

_LIB: Optional[types.SimpleNamespace] = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def target(source: pathlib.Path, defines: Sequence[str] = ()) -> pathlib.Path:
    """The library built from ``source`` with :data:`NVCC_FLAGS` and a
    ``-D`` for each of ``defines``."""
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def _source(name: str) -> pathlib.Path:
    for src in SOURCES:
        if src.name == name:
            return src
    raise ValueError(f"{name}: not one of {[s.name for s in SOURCES]}")


def build(variants: Iterable[Tuple[str, Sequence[str]]] = ()) -> str:
    """Compile every source not built yet, and each (source file name,
    defines) of ``variants`` not built yet, all at once; return nvcc's
    output (the ``-Xptxas -v`` register/spill summary, empty when every
    library is reused). Raises if a compile fails."""
    jobs = [(s, ()) for s in SOURCES]
    jobs += [(_source(name), tuple(defines)) for name, defines in variants]
    todo = list(dict.fromkeys(
        (s, d) for s, d in jobs if not target(s, d).exists()))
    if not todo:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, defines in todo:
        out = target(src, defines)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, out, tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
             str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs, failed = [], []
    for src, out, tmp, proc in procs:
        text, _ = proc.communicate()
        logs.append(text)
        if proc.returncode != 0:
            failed.append(f"CUDA build of {out.name} ({src.name}) failed "
                          f"(nvcc exit {proc.returncode}):\n{text}")
        else:
            # atomic: a concurrent build never sees half a file
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def _bind(libs) -> dict:
    """The launchers of :data:`SIGNATURES` that ``libs`` export, typed."""
    fns = {}
    for name, argtypes in SIGNATURES.items():
        fn = next((getattr(lib, name) for lib in libs
                   if hasattr(lib, name)), None)
        if fn is not None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


def library() -> types.SimpleNamespace:
    """Every launcher of :data:`SIGNATURES`, bound from the library that
    exports it; the libraries are built at first use."""
    global _LIB
    if _LIB is None:
        build()
        fns = _bind([ctypes.CDLL(str(target(s))) for s in SOURCES])
        missing = sorted(set(SIGNATURES) - set(fns))
        if missing:
            raise RuntimeError(f"no library exports {missing}")
        _LIB = types.SimpleNamespace(**fns)
    return _LIB


@contextlib.contextmanager
def variant(source: str, *defines: str):
    """Run the launchers of ``source`` (a file name of :data:`SOURCES`)
    from its build with ``-D`` ``defines`` while the block runs, e.g.
    ``variant("sparse_row.cu", "SPARSE_ROW_WARPS=4")``: another block
    shape, for measurement. Built here unless :func:`build` built it."""
    global _LIB
    base = library()
    build([(source, defines)])
    fns = _bind([ctypes.CDLL(str(target(_source(source), defines)))])
    _LIB = types.SimpleNamespace(**{**vars(base), **fns})
    try:
        yield
    finally:
        _LIB = base


def check_launch(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` after a launch: a refused
    launch never runs, and a later synchronize would not report it."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
