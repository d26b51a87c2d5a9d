"""Build and load the CUDA sources under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with :mod:`ctypes`.  All
sources build at once, in parallel, at the first CUDA use; nothing is
compiled or loaded when a module is imported.  The output goes to
``build/repro_torch_kernels/<hash>/`` at the root of the checkout, keyed
by a hash of every file in ``csrc/`` and of the compiler flags, so an
edited source never loads a stale library.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception.
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

__all__ = ["CSRC", "BUILD_ROOT", "NVCC_FLAGS", "build_all", "library",
           "library_file", "check", "check_operand", "stream"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
#: per-source ptxas register/shared-memory report of the last build
build_log: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, all started
    together) unless this hash's libraries exist; load them.  Returns
    ``{name: ctypes.CDLL}``."""
    with _lock:
        if _libs:
            return _libs
        out_dir = BUILD_ROOT / _sources_hash()
        out_dir.mkdir(parents=True, exist_ok=True)
        sources = sorted(CSRC.glob("*.cu"))
        procs = []
        for src in sources:
            lib = out_dir / f"lib{src.stem}.so"
            if lib.exists():
                continue
            tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(src)]
            procs.append((src, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, lib, tmp, proc in procs:
            log, _ = proc.communicate()
            build_log[src.stem] = log
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, lib)  # atomic: concurrent builders agree
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for src in sources:
            _libs[src.stem] = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
        return _libs


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` with ``argtypes`` set
    from ``signatures`` (``{symbol: [ctypes types]}``; every entry point
    returns an int error code)."""
    lib = build_all()[name]
    for symbol, argtypes in signatures.items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library_file(name: str) -> Path:
    """Where :func:`build_all` puts the library of ``csrc/<name>.cu``."""
    return BUILD_ROOT / _sources_hash() / f"lib{name}.so"


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def check_operand(t: torch.Tensor, name: str,
                  length: int | None = None) -> None:
    """Raise unless ``t`` is what the kernels read: a contiguous 1-D int32
    CUDA tensor (of ``length`` elements when given, and short enough for
    the kernels' int indices)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device.index not in (None, 0):
        # the libraries' own CUDA runtime launches on its current device, 0
        raise ValueError(f"{name} is on {t.device}; the kernels run on cuda:0")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if length is not None and t.shape[0] != length:
        raise ValueError(f"{name} has {t.shape[0]} elements, expected {length}")
    if t.shape[0] >= 1 << 31:
        raise ValueError(f"{name} has {t.shape[0]} elements; the kernels "
                         f"take fewer than 2**31")


_launch_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under a lock: the stream's partition
    sorts launch kernels from worker threads, and ``+= 1`` on a function
    attribute is not atomic across them."""
    with _launch_lock:
        wrapper.launches += 1


def stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the pointer the C
    entries take."""
    return torch.cuda.current_stream(device).cuda_stream
