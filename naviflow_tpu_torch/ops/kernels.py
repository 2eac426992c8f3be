"""K11: whole-array red-black SOR sweeps and the 5-point matvec of the
unpinned pressure-correction operator (``rbgs_sweeps`` /
``apply_poisson_kernel``).

Replaces ``naviflow_tpu/ops/pallas_kernels.py:rbgs_sweeps_pallas`` (K11a)
and ``:apply_poisson_pallas`` (K11b); the CUDA kernels are
``csrc/poisson.cu`` (its header says what bounds them on the H100).

Dispatch is the JAX wrappers' own rule (``_use_pallas``): a CUDA float32
array of at most :data:`PALLAS_MAX_CELLS` cells goes to the kernel;
anything else, a CPU tensor included, runs the plain version, as the JAX
wrapper runs its jnp path.  No solve path calls these, as in the JAX
package: they are held against their plain versions in ``chip_smoke.py``.
"""

from __future__ import annotations

import torch

from . import _cuda
from .poisson import PoissonCoeffs, apply_poisson

# The TPU kernels' whole-array VMEM limit (7 f32 arrays plus double
# buffering in 16 MB), kept so that the port launches K11 exactly where the
# reference does; not an H100 limit.
PALLAS_MAX_CELLS = 256 * 256

# sweeps a K11a launch: csrc/poisson.cu's RB_S_MAX, the number of its
# kernel's instances (a call of more sweeps refuses)
RBGS_S_MAX = 4

RBGS_LAUNCHES = 0  # K11a
MATVEC_LAUNCHES = 0  # K11b


def _use_kernel(p) -> bool:
    return (_cuda.kernel_device(p) and p.dtype == torch.float32
            and p.shape[0] * p.shape[1] <= PALLAS_MAX_CELLS)


def rbgs_sweeps_plain(p, b, c: PoissonCoeffs, n_sweeps: int = 1, omega: float = 1.5):
    """``n_sweeps`` iterations of ``solvers/pressure.rbgs_sweep(pin=False)``."""
    from ..solvers.pressure import rbgs_sweep

    for _ in range(n_sweeps):
        p = rbgs_sweep(p, b, c, omega, pin=False)
    return p


def apply_poisson_plain(p, c: PoissonCoeffs):
    return apply_poisson(p, c, pinned=False)


def _arrays(c: PoissonCoeffs):
    return [c.a_e, c.a_w, c.a_n, c.a_s]


# The coefficient set last held to the checks, and the shape it was held to:
# a solve applies one operator to many iterates, so its arrays are checked
# once per set (a tensor changed in place since is not checked again) and
# the iterate every call.  The one reference keeps one set alive.
_CHECKED = (None, None)


def _require(p, c: PoissonCoeffs, *others):
    global _CHECKED
    _cuda.require_all([p, *others], p.shape, "input")
    if _CHECKED[0] is not c or _CHECKED[1] != p.shape:
        _cuda.require_all([*_arrays(c), c.diag], p.shape, "coefficients")
        _CHECKED = (c, p.shape)


def rbgs_sweeps(p, b, c: PoissonCoeffs, n_sweeps: int = 1, omega: float = 1.5):
    """``n_sweeps`` red-black SOR sweeps (red = (i+j) even first), unpinned.
    The kernel computes ``invd = 1 / poisson_diagonal(c, pinned=False)``
    itself, so a call allocates only its output and, above
    :data:`RBGS_S_MAX` sweeps, a second buffer.  Only a CUDA float32 array
    of at most :data:`PALLAS_MAX_CELLS` cells launches the kernel: one C call
    and one launch for each :data:`RBGS_S_MAX` sweeps or fewer, ping-ponging
    between the two buffers so that the last lands in the output (no sweep
    returns a copy); any other input, a larger CUDA array included, runs
    :func:`rbgs_sweeps_plain` (plain PyTorch), and only ``RBGS_LAUNCHES``
    tells the two apart."""
    global RBGS_LAUNCHES
    if not _use_kernel(p):
        return rbgs_sweeps_plain(p, b, c, n_sweeps, omega)
    if n_sweeps < 1:
        return p.clone()
    _require(p, c, b)
    launches = -(-n_sweeps // RBGS_S_MAX)
    out = torch.empty(p.shape, dtype=p.dtype, device=p.device)
    tmp = torch.empty(p.shape, dtype=p.dtype, device=p.device) if launches > 1 else None
    lib, stream = _cuda.library(), _cuda.stream_of(p)
    src = p
    for m in range(launches):
        dst = out if (launches - 1 - m) % 2 == 0 else tmp
        # the lean call: one argument per pointer and parameter, no host array
        _cuda.check(lib.nf_rbgs_sweeps(
            src.data_ptr(), b.data_ptr(), c.a_e.data_ptr(), c.a_w.data_ptr(),
            c.a_n.data_ptr(), c.a_s.data_ptr(), c.diag.data_ptr(), dst.data_ptr(),
            p.shape[0], p.shape[1], min(RBGS_S_MAX, n_sweeps - m * RBGS_S_MAX), omega, stream),
            "rbgs_sweeps")
        RBGS_LAUNCHES += 1
        src = dst
    return out


def apply_poisson_kernel(p, c: PoissonCoeffs):
    """The unpinned 5-point matvec ``diag * p - sum(a_nb * p_nb)``.  Only a
    CUDA float32 array of at most :data:`PALLAS_MAX_CELLS` cells launches the
    kernel; any other input, a larger CUDA array included, runs
    :func:`apply_poisson_plain` (plain PyTorch), and only ``MATVEC_LAUNCHES``
    tells the two apart."""
    global MATVEC_LAUNCHES
    if not _use_kernel(p):
        return apply_poisson_plain(p, c)
    _require(p, c)
    out = torch.empty_like(p)
    # the lean call: one argument per pointer and integer, no host array
    _cuda.check(_cuda.library().nf_apply_poisson(
        p.data_ptr(), c.a_e.data_ptr(), c.a_w.data_ptr(), c.a_n.data_ptr(), c.a_s.data_ptr(),
        c.diag.data_ptr(), out.data_ptr(), p.shape[0], p.shape[1], _cuda.stream_of(p)),
        "apply_poisson")
    MATVEC_LAUNCHES += 1
    return out
