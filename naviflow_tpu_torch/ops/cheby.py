"""K9: fixed-degree Chebyshev solve of one momentum field plus its unrelaxed
residual.

Replaces ``naviflow_tpu/ops/pallas_cheby.py:chebyshev_momentum_strips``; the
CUDA kernel is ``csrc/cheby.cu`` (its header says what bounds it on the
H100 and how its halo tiles deal with that).  It runs once per field and
momentum solve where Chebyshev momentum is not merged into K1, on grids of
1536^2 and up.

On a CPU tensor :func:`chebyshev_momentum_strips` runs
:func:`chebyshev_momentum_strips_plain`, the composed PyTorch version; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .stencil import apply_stencil

# The TPU kernel's halo rows and window cap in cells (a VMEM budget), kept
# so the port admits exactly the grids the reference admits.  The CUDA
# kernel's own halo is degree + 1, so the gate keeps degree + 1 <= H.
H = 16
_CAP_CELLS = 384 * 1024

# the C entry's pointer slots, in its order (csrc/cheby.cu nf_chebyshev_strips)
SLOTS = ("x0", "a_e", "a_w", "a_n", "a_s", "a_p", "src", "a_p_un", "src_un", "theta", "delta",
         "sigma1", "x_star", "r")
LAUNCHES = 0  # kernel launches since the last reset (the CPU path never counts)


def supports_cheby_strips(shape, dtype, device) -> bool:
    """Gate (``pallas_cheby.supports_cheby_strips``): f32 on a CUDA device,
    both extents >= 1536, a strip height whose window fits the
    reference's budget."""
    if dtype != torch.float32 or not _cuda.kernel_device(device):
        return False
    ni, nj = shape
    if ni < 1536 or nj < 1536:
        return False
    lane_nj = -(-nj // 128) * 128
    return any((T + 2 * H) * lane_nj <= _CAP_CELLS and ni - 1 > T for T in (256, 128, 64, 32))


def chebyshev_momentum_strips_plain(x0, c_rel, c_un, *, theta, delta, sigma1, degree: int):
    """The composed version: ``_chebyshev_iterate`` on the relaxed system,
    then the unrelaxed residual (the relaxed links with the unrelaxed
    ``a_p``/``src``) zeroed outside the solve mask."""
    from ..solvers.momentum import _chebyshev_iterate
    from .stencil import interior_mask

    mask = interior_mask(x0.shape, 1, 1, 1, 1, device=x0.device)
    x = _chebyshev_iterate(x0, c_rel, mask, theta, delta, sigma1, degree)
    r = c_un.src - apply_stencil(x, c_rel.replace(a_p=c_un.a_p))
    return x, torch.where(mask, r, torch.zeros_like(r))


# The launch's host arrays, reused across calls: the pointer slots (filled
# per call), the integer parameters per shape and degree, the unused float.
_PTRS = (ctypes.c_longlong * len(SLOTS))()
_IP = {}
_FP = (ctypes.c_float * 1)(0.0)


def chebyshev_momentum_strips(x0, c_rel, c_un, *, theta, delta, sigma1, degree: int):
    """Chebyshev solve of one momentum field and its unrelaxed residual.

    ``x0``: the BC-applied field; ``c_rel``/``c_un``: relaxed and unrelaxed
    :class:`StencilCoeffs`; the interval scalars (floats or 0-d tensors) come
    from ``solvers.momentum._chebyshev_bounds``.  Returns ``(x_star, r_m)``,
    ``r_m`` zero outside the solve mask (its L2 norm is the interior
    residual norm)."""
    global LAUNCHES
    if not x0.is_cuda:
        return chebyshev_momentum_strips_plain(x0, c_rel, c_un, theta=theta, delta=delta,
                                               sigma1=sigma1, degree=degree)
    ni, nj = x0.shape
    if degree < 1 or degree + 1 > H:
        raise ValueError(f"degree {degree}: the kernel needs 1 <= degree <= {H - 1}")
    arrays = (x0, c_rel.a_e, c_rel.a_w, c_rel.a_n, c_rel.a_s, c_rel.a_p, c_rel.src,
              c_un.a_p, c_un.src)
    _cuda.require_all(arrays, (ni, nj), "chebyshev_momentum_strips inputs")
    dev = x0.device
    stream = _cuda.stream_of(x0)  # raises under a transform, before a pointer is read
    scalars, held = _cuda.scalar_ptrs((theta, delta, sigma1), dev)  # held until enqueued
    x_star, r_m = torch.empty((2, ni, nj), dtype=torch.float32, device=dev)  # one allocation
    ptrs = _PTRS
    ptrs[:] = [a.data_ptr() for a in arrays] + scalars + [x_star.data_ptr(), r_m.data_ptr()]
    ip = _IP.get((ni, nj, degree))
    if ip is None:
        if len(_IP) >= 32:
            _IP.clear()
        ip = _IP[(ni, nj, degree)] = (ctypes.c_int * 3)(ni, nj, degree)
    _cuda.check(_cuda.library().nf_chebyshev_strips(ptrs, ip, _FP, stream),
                "chebyshev_momentum_strips")
    LAUNCHES += 1
    return x_star, r_m
