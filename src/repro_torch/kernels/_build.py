"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``-gencode arch=compute_90a,code=sm_90a``), so the
sources build in parallel, one ``nvcc`` each, in seconds.  Nothing
is built when the package is imported: the first kernel launch builds
what it needs, and :func:`build` builds every source at once (the smoke
script calls it to time the build).  Libraries land in ``build/kernels``
at the root of the checkout, named by a hash of their sources and flags,
so an edited source is rebuilt and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
SOURCES = ("mxp_gemm", "syrk", "trsm", "potrf", "fused_column",
           "flash_attention", "flash_wgmma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

#: dtype codes of csrc/common.cuh (enum DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}

_LIBS: dict = {}
_FUNCS: dict = {}
_LOCK = threading.Lock()
#: guards every kernel's launch count and ops' call counts: service
#: workers launch from several threads, and ``+= 1`` is not atomic
COUNT_LOCK = threading.Lock()


def build_dir() -> Path:
    """``build/kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES, ptxas_info: bool = False) -> dict:
    """Compile the named sources that are not built yet, all at once.

    Returns ``{name: compiler output}`` for the sources it compiled
    (``ptxas_info`` adds ``-Xptxas -v``: registers, shared memory and
    spills per kernel).  Raises with the compiler's output if any fails.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_info else []),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    out, failed = {}, []
    for name, (tmp, p) in procs.items():
        out[name] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(out[n] for n in failed))
    return out


def function(lib: str, fn: str, argtypes: list):
    """The C entry ``fn`` of ``csrc/<lib>.cu``, built and loaded on first
    use, with its ``argtypes`` set and an ``int`` (cudaError_t) result."""
    key = (lib, fn)
    f = _FUNCS.get(key)
    if f is not None:
        return f
    with _LOCK:
        if lib not in _LIBS:
            build([lib])
            _LIBS[lib] = ctypes.CDLL(str(library_path(lib)))
        f = getattr(_LIBS[lib], fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FUNCS[key] = f
    return f


def on_cuda(what: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor is a contiguous CUDA tensor of one device
    (the kernel launches), False when every one lies on the CPU (the
    wrapper takes the plain version); anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: operands on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    return True


def require_current(what: str, t: torch.Tensor) -> None:
    """Raise unless CUDA tensor ``t`` lies on the current CUDA device.  The
    Cholesky wrappers launch on the current device's current stream (the
    executors issue each device's ops under its device and stream), so a
    kernel never launches on another card than its operands'."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(
            f"{what}: operands on {t.device} but the current CUDA device is "
            f"cuda:{torch.cuda.current_device()}; launch under "
            f"torch.cuda.device({t.device.index})")


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
