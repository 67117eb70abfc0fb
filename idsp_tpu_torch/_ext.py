"""Build and bind the CUDA kernels of `csrc/`.

The sources are compiled at first use with nvcc, for ``sm_90a``, one
nvcc process per ``.cu`` file, all started together, and linked into a
shared library with a plain C interface, under ``build/idsp_tpu_torch/``
at the root of the checkout, keyed by a hash of the sources, the nvcc
path and version, and torch's CUDA version.  The
library is loaded with ctypes: pointers and the stream go as
``c_void_p``, sizes as ``c_int``.  Every C entry point launches on the
stream it is given and returns ``cudaGetLastError()``; `check` raises
if that is not 0.

Nothing here runs at import: the CPU tests import every module, and a
CPU-only machine has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "idsp_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures (see the .cu files): pointers, then ints, then the stream.
_SIGNATURES = {
    "idsp_df1_bank_q": [_P] * 6 + [_I] * 9 + [_P],
    "idsp_df1_bank_q_dec": [_P] * 6 + [_I] * 10 + [_P],
    "idsp_ddc_cascade": [_P] * 13 + [_I] * 10 + [_P, _P, _P],
    "idsp_ddc_mix_df1": [_P] * 8 + [_I] * 9 + [_P],
    "idsp_lowpass_bank": [_P] * 4 + [_I] * 6 + [_P],
    "idsp_pll_bank": [_P] * 4 + [_I] * 5 + [_P],
    "idsp_ddc_bank_lp": [_P] * 11 + [_I] * 10 + [_P],
    "idsp_ddc_bank_df1": [_P] * 12 + [_I] * 13 + [_P],
    "idsp_hbf_dec_cascade": [_P] * 4 + [_I] * 4 + [_P, _P, _P],
    "idsp_hbf_int_cascade": [_P] * 4 + [_I] * 4 + [_P, _P, _P],
    "idsp_cic_dec_bank": [_P] * 4 + [_I] * 4 + [_P],
    "idsp_cic_int_bank": [_P] * 4 + [_I] * 4 + [_P],
}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output (ptxas register/smem report) of the build


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the idsp_tpu_torch kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library() -> ctypes.CDLL:
    """The kernel library, built on first call (thread-safe)."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        nvcc = _nvcc()
        version = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, check=True).stdout
        h = hashlib.sha256()
        for p in _sources():
            h.update(p.name.encode())
            h.update(p.read_bytes())
        # a checkout reused with another toolkit or torch rebuilds
        for part in (" ".join(NVCC_FLAGS), nvcc, version,
                     str(torch.version.cuda)):
            h.update(part.encode())
        out_dir = BUILD_ROOT / h.hexdigest()[:16]
        so = out_dir / "libidsp_tpu_torch.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tag = f".{os.getpid()}"
            objs, procs = [], []
            for src in sorted(CSRC.glob("*.cu")):
                obj = out_dir / f"{src.stem}{tag}.o"
                objs.append(str(obj))
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            logs = [p.communicate()[0] for p in procs]  # waits for each
            build_log = "".join(logs)
            if any(p.returncode for p in procs):
                raise RuntimeError(f"nvcc failed:\n{build_log}")
            tmp = out_dir / f".libidsp_tpu_torch{tag}.so"
            res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                                  *objs], capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{res.stdout}"
                                   f"{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def pointers(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers (a ``void* const*``
    argument); the caller keeps the tensors alive over the call."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require(name: str, t: torch.Tensor, device: torch.device, dtype,
            shape) -> None:
    """Raise unless ``t`` is a contiguous tensor on the CUDA ``device``
    with the given dtype and shape."""
    if device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must be on {device} (CUDA), got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
