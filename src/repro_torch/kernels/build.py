"""Build the CUDA kernels in `csrc/` with nvcc and load them with ctypes.

Each `csrc/*.cu` source becomes one shared library with a plain C interface
(pointers, sizes and the stream in; `cudaGetLastError()` out), built for
`sm_90a` at first use into `kernels/_build/` (listed in `.gitignore`).  The
file name carries a hash of the source, every header under `csrc/` and the
flags, so an edited source or header is rebuilt and a stale library is
never loaded.  `load_all()` starts one nvcc per source at once and waits
for all of them.

A failed build raises with nvcc's stderr; nothing falls back to the plain
PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = ("ntt", "ntt4", "pointwise", "he_agg", "lift", "mask")
# -split-compile=0 runs nvcc's optimizer on every CPU, so that ntt4.cu's 26
# kernels build within ntt.cu's time; the other sources' SASS is the same
# with it as without
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-split-compile=0")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# argtypes of every exported launch function, by library
SIGNATURES = {
    "ntt": {
        "ntt_fwd_launch": (_P, _P, _P, _P, _P, _LL, _I, _I, _P),
        "ntt_inv_launch": (_P, _P, _P, _P, _P, _P, _LL, _I, _I, _P),
    },
    "ntt4": {
        "ntt4_fwd_launch": (_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I,
                            _P),
        "ntt4_inv_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I,
                            _P),
    },
    "pointwise": {
        "mul_add_launch": (_P, _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P,
                           _P, _LL, _I, _I, _P),
    },
    "he_agg": {
        "weighted_sum_launch": (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _P),
        "weighted_accum_launch": (_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I,
                                  _P),
        "weighted_accum_chunks_launch": (_P, _P, _P, _P, _P, _P, _LL, _I, _I,
                                         _I, _P),
    },
    "lift": {
        "mod_lift_launch": (_P, _P, _P, _LL, _I, _I, _P),
    },
    "mask": {
        "mask_split_launch": (_P, _P, _P, _LL, _LL, _LL, _P, _P, _P),
        "mask_merge_launch": (_P, _P, _LL, _P, _P, _P, _LL, _P),
    },
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from the CUDA toolkit PyTorch found."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under CUDA_HOME)")


def _lib_path(name: str) -> pathlib.Path:
    """The library's path, named by a hash of the flags, every header under
    `csrc/` (any source may include any of them) and the source."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, nvcc: str):
    """Start nvcc for one source; returns (Popen, tmp path, final path)."""
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _bind(name: str, path: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def load_all(names=SOURCES) -> dict[str, ctypes.CDLL]:
    """Build (in parallel, where missing) and load the named libraries."""
    with _LOCK:
        todo = [n for n in names
                if n not in _LIBS and not _lib_path(n).exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = nvcc_path()
            jobs = [(n, *_start(n, nvcc)) for n in todo]
            errors = []
            for n, proc, tmp, out in jobs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc failed for csrc/{n}.cu "
                                  f"(exit {proc.returncode}):\n{err}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, out)
            if errors:
                raise RuntimeError("\n".join(errors))
        for n in names:
            if n not in _LIBS:
                _LIBS[n] = _bind(n, _lib_path(n))
        return {n: _LIBS[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built at first use."""
    lib = _LIBS.get(name)
    return lib if lib is not None else load_all((name,))[name]


# ---------------------------------------------------------------------------
# helpers the wrappers share
# ---------------------------------------------------------------------------


def require_cuda(name: str, t) -> None:
    """The wrappers run the plain version only for CPU tensors; anything
    else must be a CUDA tensor, which goes to the kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device} are not supported "
                         "(CUDA runs the kernel, CPU the plain version)")


def check_int32(name: str, t, device, *, contiguous: bool = True) -> None:
    """Raise unless `t` is an int32 tensor on `device` (contiguous, or at
    least unit-stride in its last axis)."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32 residues, got "
                        f"{t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if not contiguous and t.dim() and t.stride(-1) != 1:
        raise ValueError(f"{name}: last axis must be unit-stride")


def log2_exact(n: int, what: str) -> int:
    if n < 2 or n & (n - 1):
        raise ValueError(f"{what} must be a power of two >= 2, got {n}")
    return n.bit_length() - 1


def launch(lib_name: str, fn: str, *args) -> None:
    """Call one launch function on the current stream of the device of the
    first tensor argument; raise if the launch was refused."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    stream = torch.cuda.current_stream(dev).cuda_stream
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    with torch.cuda.device(dev):
        err = getattr(library(lib_name), fn)(*cargs, stream)
    if err:
        raise RuntimeError(f"{fn}: launch failed with cudaError_t {err}")
