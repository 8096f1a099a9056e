"""Build and load the port's hand-written CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc`` for Hopper (``sm_90a``)
into ONE shared library with a plain C interface, loaded with ``ctypes``
-- no PyTorch headers, so a cold build takes seconds. The build runs at
first use into ``build/sbm_torch_kernels/`` at the repository root; the
library's file name carries a hash of the sources and flags, so an edited
source never loads a stale library.

``--fmad=false`` keeps every float multiply and add a separate IEEE
rounding (the fastAtan2 polynomial in ``frontend.cu`` must round exactly
as the plain version does), and the absence of ``--use_fast_math`` keeps
division IEEE.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; ``check`` raises on any
non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "sbm_torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures: name -> argtypes (every entry returns the CUDA error code)
SIGNATURES = {
    # img, out, B, H, W, T, thr_sq, stream
    "sbm_quant_spread": (_P, _P, _I, _I, _I, _I, _F, _P),
    # lmflat, lm_stride, off, pos, rmin, S, cnt, B, K, N, M, stream
    "sbm_coarse_scores": (_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # lmflat, lm_stride, fx, fy, label, fvalid, k, wx, wy, live,
    # best, raw, B, C, N, w_img, h_img, T, stream
    "sbm_refine_windows": (_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _P),
}


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError(
            "nvcc not found (CUDA toolkit needed to build the kernels)")
    return nvcc


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR,
                        f"libsbm_torch_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float]:
    """Compile the library unless it exists; returns (path, seconds spent
    compiling). nvcc's resource report (-Xptxas -v) goes to nvcc.log
    beside the library."""
    path = library_path()
    if os.path.isfile(path):
        return path, 0.0
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cus = [s for s in _sources() if s.endswith(".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
                           *cus], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path, seconds


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
