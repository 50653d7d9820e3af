"""Build and bind the port's hand-written CUDA kernels.

Each `csrc/*.cu` file becomes one shared library with a plain C interface
(`nvcc -gencode arch=compute_90a,code=sm_90a -shared`), loaded with ctypes:
no PyTorch headers, so a build takes seconds rather than minutes.  All
sources compile in parallel, one nvcc each, on first use, into
`build/torch_kernels/` under the repository root; a library's file name
carries a hash of the sources, so an edit rebuilds it.

`CudaKernel` is one kernel's binding: its C entry point and its launch
count.  A wrapper in `ops/` calls it only for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all nvcc processes at
    once.  Returns {source name: compiler report} for the ones built (the
    ptxas lines give registers, shared memory and spills per kernel);
    raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    reports, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[src.name] = log
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(source: str) -> ctypes.CDLL:
    """The loaded library of csrc/<source>, built first if missing."""
    lib = _libs.get(source)
    if lib is None:
        path = _lib_path(CSRC / source)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.gs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gs_cuda_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


KERNELS: dict[str, "CudaKernel"] = {}


class CudaKernel:
    """One hand-written kernel: source file, C entry point, launch count.

    Calling it launches the kernel (the entry point returns
    cudaGetLastError(), and a non-zero code raises) and adds one to
    `launches`."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = load(self.source).gs_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error "
                               f"{err} ({msg})")
        self.launches += 1


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless t has this dtype, device and shape (None = any size in
    that dimension) and is contiguous: what a kernel's pointers assume."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if len(shape) != t.dim() or any(s is not None and s != d
                                    for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def on_cuda(device) -> bool:
    """True for a CUDA device (a wrapper launches its kernel), False for
    the CPU (it runs the plain PyTorch version); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {device}")


def stream_ptr(device) -> int:
    """The current CUDA stream of device, for a ctypes.c_void_p argument."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
