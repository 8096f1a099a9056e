"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` for Hopper
(``sm_90a``), all of them at once, and the objects link into ONE shared
library with a plain C interface, loaded with ``ctypes`` -- no PyTorch
headers, so a cold build takes seconds. The build runs at first use into
``build/sbm_torch_kernels/`` at the repository root; the library's file
name carries a hash of the sources and flags, so an edited source never
loads a stale library.

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

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures: name -> argtypes (every entry returns the CUDA error code)
SIGNATURES = {
    # img, mask, out, quant, B, H, W, T, RS, n_ori, channels, patch_2843,
    # thr_sq, stream (mask and quant may be null)
    "sbm_quant_spread": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _F, _P),
    # x, y, out, n, stream: frontend.cu's fastAtan2 alone (tests)
    "sbm_phase_deg": (_P, _P, _P, _I, _P),
    # lmflat, lm_stride, off, pos, rmin, S, cnt, B, K, N, M, G, chunk,
    # stream (pos, rmin and cnt null: the count is off)
    "sbm_coarse_scores": (_P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _P),
    # lmflat, lm_stride, slot_start, slots, segs, pre, pos, rmin, S, cnt,
    # B, NSEG, K, M, stream
    "sbm_chain_scores": (_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _P),
    # cnt, pos, rmin, t4n, n_above, work, meta, status, B, K, M, C, L,
    # stream
    "sbm_extract_prefix": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _P),
    # S, work, meta, status, k_out, x_out, y_out, sc_out, valid_out, B, K,
    # M, C, T, W, L, vec, stream
    "sbm_extract_counted": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _I, _P),
    # Sfull, D, M, W, slot_of_k, width, height, nfeat, k, x, y, valid,
    # threshold, k_out, x_out, y_out, sim_out, valid_out, T, w_img, h_img,
    # B, C, stream
    "sbm_map_refine": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # lmflat, lm_stride, fx, fy, label, fvalid, k, wx, wy, live,
    # best, raw, part, B, C, N, w_img, h_img, T, CB, G, chunk, stream
    # (part null when CB is 1)
    "sbm_refine_windows": (_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # src, dst, planes, H, W, stream
    "sbm_pyr_down": (_P, _P, _I, _I, _I, _P),
    # sp, out, B, H, W, T, XC, n_ori, stream
    "sbm_linear_memories": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    # off, normal, has, subpix, pts, origins, pt_valid, out, inliers,
    # valid, C, N, H, W, iters, r2, min_inliers, stream
    "sbm_icp_steps": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, _F, _I, _P),
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
    compiling). nvcc's resource reports (-Xptxas -v) go to nvcc.log
    beside the library."""
    path = library_path()
    if os.path.isfile(path):
        return path, 0.0
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cus = [s for s in _sources() if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(cu)}.{os.getpid()}"
                         ".o") for cu in cus]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c",
                               "-o", obj, cu], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cu, obj in zip(cus, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [(cu, proc.returncode, log) for cu, proc, log
              in zip(cus, procs, logs) if proc.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed = [("link", link.returncode, logs[-1])]
    seconds = time.perf_counter() - t0
    for obj in objs:
        if os.path.isfile(obj):
            os.remove(obj)
    with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
        f.write("\n".join(logs))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{os.path.basename(name)} ({rc}):\n{log[-4000:]}"
            for name, rc, log in failed))
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
