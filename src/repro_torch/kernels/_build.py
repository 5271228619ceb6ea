"""Build ``csrc/zen_infer.cu`` with nvcc and bind it by ctypes.

The source compiles to a shared library with a plain C interface, named by
a hash of its source and flags, into ``build/`` beside this file (listed in
``.gitignore``). A library already built from the same source and flags is
reused. Nothing here runs at import: the first launch builds and loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "zen_infer.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"

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
# argtypes of the source's extern "C" launchers
SIGNATURES = {
    "zen_infer_gathered": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P),
    "zen_infer_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _F, _F, _P),
}

_LIB: Optional[ctypes.CDLL] = None


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


def _target() -> pathlib.Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{SOURCE.stem}_{digest}.so"


def build() -> str:
    """Compile the source unless already built; return nvcc's output (the
    ``-Xptxas -v`` register/spill summary, empty for a reused library).
    Raises if the compile fails."""
    out = _target()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA build of {SOURCE.name} failed (nvcc exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    # atomic: a concurrent build never sees half a file
    os.replace(tmp, out)
    return proc.stdout


def library() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _LIB
    if _LIB is None:
        build()
        lib = ctypes.CDLL(str(_target()))
        for fn, argtypes in SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check_launch(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` after a launch: a refused
    launch never runs, and a later synchronize would not report it."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
