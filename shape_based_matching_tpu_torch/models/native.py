"""Build and load the host helpers (``csrc/host.cpp``).

The two greedy passes of feature extraction and the greedy NMS of match
boxes run on the host: they are sequential by definition, and a
10,000-angle bank or an 8191-feature template makes their Python loops
the slowest part of training. The helpers compile at first use with the host C++ compiler into
``build/sbm_torch_host/`` at the repository root, under a file name that
carries a hash of the source and flags, and load with ``ctypes``. A
failed build raises with the compiler's message: there is no silent
fallback to the Python loops, which stay in ``models/training.py`` and
``utils/nms.py`` as the plain versions the tests compare against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PKG_DIR, "csrc", "host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "sbm_torch_host")
# ISO C++ and no contraction: the float distances of the scattered
# selection round as the plain version's do
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++14", "-ffp-contract=off")

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (c++ or g++, or $CXX) to "
                           "build the training helpers")
    return cxx


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsbm_torch_host_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the helpers unless the library exists; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    path = library_path()
    if os.path.isfile(path):
        return path
    cxx = compiler()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building {os.path.basename(SOURCE)} with {cxx} "
                           f"failed ({proc.returncode}):\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded helper library, built on first use."""
    lib = ctypes.CDLL(build())
    lib.sbm_greedy_accept.argtypes = (ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, _I32P, _I32P,
                                      ctypes.POINTER(ctypes.c_uint8))
    lib.sbm_greedy_accept.restype = None
    lib.sbm_select_scattered.argtypes = (ctypes.c_int, _I32P, _I32P,
                                         ctypes.c_int, ctypes.c_float,
                                         _I32P)
    lib.sbm_select_scattered.restype = ctypes.c_int
    lib.sbm_nms_boxes.argtypes = (ctypes.c_int, _F32P, _I32P, ctypes.c_int,
                                  ctypes.c_float, ctypes.c_float, _I32P)
    lib.sbm_nms_boxes.restype = ctypes.c_int
    return lib
