"""Builds the port's CUDA kernels and loads them with ctypes.

Every ``csrc/*.cu`` compiles with its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects link into one shared library with a
plain C interface under ``build/torch_ext/<hash of the sources>/``.  The
library is built at first use (``load()``), never at import, so the CPU
tests import every module without a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
SIGNATURES = {
    "fedavg_bf16": [_P, _P, _P, _I, _L, _P],
    "fedavg_f32": [_P, _P, _P, _I, _L, _P],
    "flash_fwd_bf16": [_P] * 5 + [_I] * 10 + [_P],
    "flash_fwd_f32": [_P] * 5 + [_I] * 10 + [_P],
    "qagg": [_P, _P, _P, _P, _I, _L, _L, _P],
    "quant8_quantize_bf16": [_P, _P, _P, _L, _P],
    "quant8_quantize_f32": [_P, _P, _P, _L, _P],
    "quant8_dequantize": [_P, _P, _P, _L, _P],
    "wkv6_bf16": [_P] * 9 + [_L] + [_I] * 7 + [_P],
    "wkv6_f32": [_P] * 9 + [_L] + [_I] * 7 + [_P],
}

_lib = None
build_log = ""          # ptxas register/shared-memory report of the last build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if not cached) and return the library's path."""
    global build_log
    srcs = _sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib_path = out_dir / "librepro_torch_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    procs = []
    for src in srcs:
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp_lib = tmp / lib_path.name
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call; every C function returns
    ``cudaGetLastError()`` after its launch."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int      # cudaError_t
        _lib = lib
    return _lib


# the active op counters (``launch.op_analysis.OpCounter``): a kernel's
# launch on a card, and a meta call that stands for one, reports its
# ``cost()`` to each
counters: list = []


def record(name: str, cost, *args) -> None:
    """Reports one call of kernel ``name`` to every active op counter:
    ``cost(*args)`` = (FLOPs, bytes), worked out only when one is."""
    if counters:
        flops, nbytes = cost(*args)
        for c in counters:
            c.kernel(name, flops, nbytes)


def check_device(t, what: str) -> None:
    """Raise unless ``t`` lies on a Hopper (compute capability 9.0) card."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: tensor on {t.device}, not on a CUDA card")
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"{what}: the kernel is built for sm_90a (Hopper); this card is "
            f"sm_{cap[0]}{cap[1]}")


def check_status(status: int, what: str) -> None:
    """Raise on a refused or failed launch (a ``cudaError_t`` other than 0)."""
    if status != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {status}")


def stream_ptr(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
