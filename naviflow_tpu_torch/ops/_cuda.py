"""Build, load and call the port's hand-written CUDA kernels.

At the first CUDA use, ``nvcc`` compiles every ``naviflow_tpu_torch/csrc/*.cu``
for ``sm_90a`` (one process per source, all started together) and links
the objects into one shared library with a plain C interface, under
``naviflow_tpu_torch/_build/`` (git-ignored), named by a hash of the sources
and flags; later uses load the same file.  The library is loaded with
``ctypes``: each C entry point takes a host array of device pointers (as
64-bit integers), host arrays of integer and float parameters, and the
stream as ``c_void_p``; it returns ``cudaGetLastError()`` after its launch, and :func:`check`
raises on a non-zero code.  A failed ``nvcc`` raises with its stderr.  The
entries of :data:`_SIGNATURES` have their own argument lists: K11a's and
K11b's (the lean call) take one ``c_void_p``, ``c_int`` or ``c_float`` per
argument, so a call builds no host array.

Under ``torch.func.vmap`` alone (no other transform) the gates answer from
the device (:func:`kernel_device`), and K1-K5 and K7-K10 run through their
batching rules (``ops/asmcheby.py``, ``ops/strip.py``, ``ops/mg.py``,
``ops/krylov.py``, ``ops/assembly.py``, ``ops/cheby.py``,
``ops/plane_strip.py``): the rule gets plain tensors with a leading case
axis and launches the kernel's batched entry (one thread-block cluster a
case for the cluster kernels, a grid axis over the cases for K2, K8 and
K10, (case, tile) items for K1's and K9's persistent blocks) with the
active flags of :func:`case_mask` (K7's grid form: one cooperative grid
for every case).  Every other kernel (K6 outside its own batched entry,
K11) raises at its launch (:func:`stream_of`), and every kernel raises
under any other transform.  The solvers' data-dependent loops run through
``ops/while_loop.py``, whose batching rule keeps one host read an
iteration for every case and nests its body's kernels in a
:func:`case_mask` of the cases still iterating.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
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
    # registers, shared memory and spills of every kernel, kept in build_log
    "-Xptxas", "-v",
)

_ARGS = [ctypes.POINTER(ctypes.c_longlong),  # device pointers
         ctypes.POINTER(ctypes.c_int),       # integer parameters
         ctypes.POINTER(ctypes.c_float),     # float parameters
         ctypes.c_void_p]                    # stream
# C entry points (see csrc/*.cu for each one's pointer and parameter order)
_KERNELS = ("nf_asmcheby_pair", "nf_asmcheby_pair_phases", "nf_strip_down", "nf_strip_up",
            "nf_fused_vcycle", "nf_fused_vcycle_phases",
            "nf_asmcheby_pair_batched", "nf_strip_down_batched", "nf_strip_up_batched",
            "nf_fused_vcycle_batched",
            "nf_galerkin_levels", "nf_fused_mg_solve", "nf_bicgstab", "nf_fused_outer_step",
            "nf_galerkin_levels_batched", "nf_fused_mg_solve_batched", "nf_bicgstab_batched",
            "nf_bicgstab_grid_batched",
            "nf_fused_outer_step_phases", "nf_fused_outer_step_batched",
            "nf_fused_assembly_pair", "nf_chebyshev_strips",
            "nf_plane_strip_down", "nf_plane_strip_up",
            "nf_fused_assembly_pair_batched", "nf_chebyshev_strips_batched",
            "nf_plane_strip_down_batched", "nf_plane_strip_up_batched",
            "nf_grid_sync_probe", "nf_cluster_sync_probe")
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"nf_apply_poisson": [_P] * 7 + [_I, _I, _P],  # p, 4 links, diag, out; nx, ny
               # p, b, 4 links, diag, out; nx, ny, n_sweeps; omega
               "nf_rbgs_sweeps": [_P] * 8 + [_I, _I, _I, ctypes.c_float, _P],
               "nf_launch_floor_probe": [_I, _I, _P],                # blocks, threads
               "nf_step_cluster_size": [_I, ctypes.POINTER(_I)],     # algo; the size out
               "nf_step_max_clusters": [_I, _I, ctypes.POINTER(_I)],  # algo, size; count out
               "nf_vcycle_cluster_size": [_I, ctypes.POINTER(_I)],   # timed; the size out
               "nf_mg_solve_cluster_size": [ctypes.POINTER(_I)],     # the size out
               "nf_bicgstab_cluster_size": [ctypes.POINTER(_I)],     # the size out
               "nf_asmcheby_blocks_per_sm": [_I, ctypes.POINTER(_I)],  # degree; blocks out
               "nf_galerkin_cluster_size": [ctypes.POINTER(_I)],     # the size out
               # kernel (0 K7, 1 K5, 2 K4, 3 K3), size; how many clusters fit at once, out
               "nf_case_max_clusters": [_I, _I, ctypes.POINTER(_I)],
               "nf_strip_down_blocks_per_sm": [_I, _I, ctypes.POINTER(_I)],  # five, sweeps; out
               "nf_strip_up_blocks_per_sm": [_I, _I, ctypes.POINTER(_I)]}    # five, sweeps; out

_lib = None
_lock = threading.Lock()
build_seconds = None  # wall time of this process's nvcc run (None: cached)
build_log = {}  # source name -> nvcc's stderr (ptxas's report) of this process's build


def under_transform() -> bool:
    """True inside a ``torch.func`` transform (``jvp``, ``vmap``, ...), a
    forward-AD dual level or a ``make_fx`` trace (``torch.func.linearize``
    traces with both).  A ``ctypes`` kernel has no rule there: it would
    read the primal and drop the tangent or the trace."""
    from torch.autograd import forward_ad

    return (forward_ad._current_level >= 0
            or torch._C._functorch.peek_interpreter_stack() is not None
            or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.PROXY) is not None)


def under_vmap() -> bool:
    """True inside ``torch.func.vmap`` and no other transform: no other
    ``torch.func`` level, forward-AD dual level or ``make_fx`` trace.  There
    the kernels with a batching rule (K1-K5, K7-K10) run it."""
    if not under_transform():
        return False
    from torch.autograd import forward_ad
    from torch._C._functorch import TransformType
    from torch._functorch.pyfunctorch import retrieve_all_functorch_interpreters

    if (forward_ad._current_level >= 0
            or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.PROXY) is not None):
        return False
    return all(i.key() == TransformType.Vmap for i in retrieve_all_functorch_interpreters())


def refuse_under_transform(what: str):
    """Raise where a kernel would run under a transform (no silent switch
    to the plain version)."""
    if under_transform():
        raise RuntimeError(
            f"{what}: a CUDA kernel cannot run under torch.func or forward-mode AD (only "
            "K1-K5 and K7-K10 have a batching rule, and only under "
            "torch.func.vmap alone); "
            "differentiate the plain PyTorch path (backend='composed', or the plain "
            "assembly, as newton.make_residual does)")


def kernel_device(x) -> bool:
    """The port's kernel gate: the tensor (or device) is a CUDA one.  It
    raises on a CUDA device under a ``torch.func`` transform
    (:func:`refuse_under_transform`) other than ``vmap`` alone
    (:func:`under_vmap`), where it answers from the device: the kernel the
    gate admits then runs its batching rule, or raises at its launch.

    It takes the place of the JAX package's ``jax.default_backend() ==
    'tpu'`` test in every gate."""
    dev = x if isinstance(x, torch.device) else x.device
    if dev.type != "cuda":
        return False
    if not under_vmap():
        refuse_under_transform("kernel gate")
    return True


_CASE_MASK = []


@contextlib.contextmanager
def case_mask(active):
    """Inside: the active flags (a (B,) bool tensor) of the cases of a
    ``torch.func.vmap`` over B cases, which a batching rule hands its
    kernel: a frozen case's clusters leave at once (the lockstep loop's
    frozen cases, ``algorithms/batch.py``)."""
    _CASE_MASK.append(active)
    try:
        yield
    finally:
        _CASE_MASK.pop()


def active_cases(cases: int):
    """The flags of the innermost :func:`case_mask` (None outside one:
    every case is active); raises if they are not for ``cases`` cases."""
    if not _CASE_MASK:
        return None
    active = _CASE_MASK[-1]
    if tuple(active.shape) != (cases,):
        raise ValueError(f"case_mask holds {tuple(active.shape)} flags for a batch of {cases}")
    return active


def case_first(x, dim, cases: int):
    """A batching rule's operand with its case axis first: moved from
    ``dim``, or (``dim`` None: shared by every case) expanded to ``cases``
    (case stride 0); each case's slice made contiguous where it is not."""
    x = x.expand(cases, *x.shape) if dim is None else x.movedim(dim, 0)
    return x if tuple(x.stride()[1:]) == _contiguous(x.shape[1:]) else x.contiguous()


def _contiguous(shape):
    return tuple(math.prod(shape[k + 1:]) for k in range(len(shape)))


def case_stride(x, cases: int, shape, dtype, name: str) -> int:
    """Check ``x`` is (cases, *shape) of ``dtype`` on the card with each
    case's slice contiguous (one test a tensor); its case stride in
    bytes (0: one array shared by every case)."""
    shape = tuple(shape)
    want = _contiguous(shape)
    if not (kernel_device(x) and x.dtype is dtype and tuple(x.shape) == (cases,) + shape
            and tuple(x.stride()[1:]) == want):
        raise ValueError(f"{name}: expected a CUDA {dtype} tensor of shape "
                         f"{(cases,) + shape} with each case contiguous, got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()} on {x.device}")
    return x.stride(0) * x.element_size()


def case_strides(arrays, cases: int, shape, dtype, what: str):
    """:func:`case_stride` of arrays of one shape, as one comparison a
    tensor on the common path; where one fails, the full checks of every
    array, which raise with the reason."""
    full, want = torch.Size((cases, *shape)), _contiguous(tuple(shape))
    out = []
    for a in arrays:
        if not (a.is_cuda and a.dtype is dtype and a.shape == full and a.stride()[1:] == want):
            return [case_stride(b, cases, shape, dtype, f"{what} [{k}]")
                    for k, b in enumerate(arrays)]
        out.append(a.stride(0) * a.element_size())
    return out


def case_flags(active, cases: int):
    """The active flags of a batched plain version's case loop, as a list
    of bools (None: every case active)."""
    return [True] * cases if active is None else active.tolist()


def case_slots(h, groups, active, cases: int, what: str) -> int:
    """Fill a batched entry's host slots ``h.ptrs`` (the single entry's
    slots, the active flags last, then each slot's case stride in the
    second half of ``h.half`` slots): the inputs of ``groups`` (lists of
    arrays of one shape, in slot order) from slot 0 with their case
    strides (one test a tensor), and the active flags (``h.ones`` for
    None); returns the next slot, where the caller puts the outputs."""
    k, half = 0, h.half
    for arrays, shape in groups:
        h.ptrs[k:k + len(arrays)] = [a.data_ptr() for a in arrays]
        h.ptrs[half + k:half + k + len(arrays)] = case_strides(arrays, cases, shape,
                                                               torch.float32, what)
        k += len(arrays)
    flags = h.ones if active is None else active
    h.ptrs[half - 1] = flags.data_ptr()
    h.ptrs[2 * half - 1] = case_stride(flags, cases, (), torch.bool, "active")
    return k


def case_max_clusters(kernel: int, size: int, device=None) -> int:
    """How many clusters of ``size`` CTAs of the batched K7 (0), K5 (1), K4
    (2) or K3 (3) the card on ``device`` holds at once: a batch of more
    cases runs in waves."""
    with torch.cuda.device(device):
        count = ctypes.c_int(0)
        check(library().nf_case_max_clusters(kernel, size, ctypes.byref(count)),
              "case_max_clusters")
    return count.value


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
    """Run the commands concurrently; raise with the stderr of a failure,
    else return each command's stderr."""
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
    failed, errs = [], []
    for cmd, proc in procs:
        _, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return errs


def _build(out: Path):
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    t0 = time.perf_counter()
    errs = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                 for src, obj in zip(sources, objs)])
    build_log.update({src.name: err for src, err in zip(sources, errs)})
    tmp = out.with_name(f"{tag}.tmp.so")
    _run([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    build_seconds = time.perf_counter() - t0


def library():
    """The loaded kernel library, built on first use (the lock is taken only
    until it is loaded).  Every launch goes through it, so a launch under a
    ``torch.func`` transform raises here."""
    global _lib
    refuse_under_transform("kernel launch")
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name in _KERNELS:
                getattr(lib, name).argtypes = _ARGS
                getattr(lib, name).restype = ctypes.c_int
            for name, args in _SIGNATURES.items():
                getattr(lib, name).argtypes = args
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
    """The raw handle of PyTorch's current stream on ``x``'s device (read
    from PyTorch's per-device current-stream state: no Stream object is
    built, and a stream switched by the caller is followed).  Every wrapper
    asks for it before its launch, so a launch under a transform raises
    here (:func:`refuse_under_transform`), before any pointer is read."""
    refuse_under_transform("kernel launch")
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def scalar_ptrs(scalars, dev):
    """Device addresses of the scalars a kernel reads from device memory,
    and the tensor holding them where they had to be made (keep it until
    the launch is enqueued): float32 one-element tensors on ``dev`` are
    passed as they are (the solvers' 0-d results); Python numbers are
    copied to the card in one tensor; anything else is stacked into one."""
    if all(torch.is_tensor(s) and s.device == dev and s.dtype == torch.float32
           and s.numel() == 1 for s in scalars):
        return [s.data_ptr() for s in scalars], None
    if not any(torch.is_tensor(s) for s in scalars):
        held = torch.tensor([float(s) for s in scalars], dtype=torch.float32, device=dev)
    else:
        held = torch.stack([torch.as_tensor(s, dtype=torch.float32, device=dev).reshape(())
                            for s in scalars])
    base = held.data_ptr()
    return [base + 4 * k for k in range(len(scalars))], held


def require_all(arrays, shape, what: str):
    """:func:`require` of every array against one shape, as one test per
    array on the common path; an array that fails gets the full checks,
    which raise with the reason."""
    shape = torch.Size(shape)
    for a in arrays:
        if not (a.is_cuda and a.dtype is torch.float32 and a.shape == shape
                and a.is_contiguous()):
            for k, b in enumerate(arrays):
                require(b, shape, f"{what} [{k}]")
            return


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
