"""Build, load and call the port's hand-written CUDA kernels.

At the first CUDA use, ``nvcc`` compiles every ``naviflow_tpu_torch/csrc/*.cu``
for ``sm_90a`` (one process per source, all started together) and links
the objects into one shared library with a plain C interface, under
``naviflow_tpu_torch/_build/`` (git-ignored), named by a hash of the sources
and flags; later uses load the same file.  The library is loaded with
``ctypes``: each C entry point takes a host array of device pointers (as
64-bit integers), host arrays of integer and float parameters, and the
stream as ``c_void_p``; it returns ``cudaGetLastError()`` after its launch, and :func:`check`
raises on a non-zero code.  A failed ``nvcc`` raises with its stderr.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # no multiply-add contraction: the kernels round like the plain
    # PyTorch versions they are held against, op by op
    "-fmad=false",
    "-lineinfo",
)

_ARGS = [ctypes.POINTER(ctypes.c_longlong),  # device pointers
         ctypes.POINTER(ctypes.c_int),       # integer parameters
         ctypes.POINTER(ctypes.c_float),     # float parameters
         ctypes.c_void_p]                    # stream
# C entry points (see csrc/*.cu for each one's pointer and parameter order)
_KERNELS = ("nf_asmcheby_pair", "nf_strip_down", "nf_strip_up", "nf_fused_vcycle",
            "nf_galerkin_levels", "nf_fused_mg_solve", "nf_bicgstab", "nf_fused_simple_step",
            "nf_grid_sync_probe")

_lib = None
_lock = threading.Lock()
build_seconds = None  # wall time of this process's nvcc run (None: cached)


def kernel_device(x) -> bool:
    """The port's kernel gate: the tensor (or device) is a CUDA one.

    It takes the place of the JAX package's ``jax.default_backend() ==
    'tpu'`` test in every gate."""
    dev = x if isinstance(x, torch.device) else x.device
    return dev.type == "cuda"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libnaviflow_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands concurrently; raise with the stderr of a failure."""
    procs = []
    try:
        for cmd in cmds:
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
    except FileNotFoundError as e:
        for _, proc in procs:
            proc.kill()
        raise RuntimeError(f"nvcc not found ({cmds[0][0]}); set CUDA_HOME or put nvcc "
                           "on PATH") from e
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _build(out: Path):
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    t0 = time.perf_counter()
    _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
          for src, obj in zip(sources, objs)])
    tmp = out.with_name(f"{tag}.tmp.so")
    _run([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    build_seconds = time.perf_counter() - t0


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name in _KERNELS:
                getattr(lib, name).argtypes = _ARGS
                getattr(lib, name).restype = ctypes.c_int
            lib.nf_error_string.argtypes = [ctypes.c_int]
            lib.nf_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().nf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(x) -> int:
    """The raw handle of PyTorch's current stream on ``x``'s device."""
    return torch.cuda.current_stream(x.device).cuda_stream


def require(x, shape, name: str):
    """Wrapper-side argument checks: CUDA, float32, shape, contiguity."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
