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

The case axis (:func:`chebyshev_momentum_strips_batched`): B fields of one
shape in one launch, the persistent blocks walking (case, tile) items, each
case with its own interval scalars (read by address), each bit-equal to
its single launch.  Under ``torch.func.vmap`` (alone)
:func:`chebyshev_momentum_strips` is its batching rule's entry.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .stencil import StencilCoeffs, apply_stencil

# The TPU kernel's halo rows and window cap in cells (a VMEM budget), kept
# so the port admits exactly the grids the reference admits.  The CUDA
# kernel's own halo is degree + 1, so the gate keeps degree + 1 <= H.
H = 16
_CAP_CELLS = 384 * 1024

# the C entry's pointer slots, in its order (csrc/cheby.cu nf_chebyshev_strips)
SLOTS = ("x0", "a_e", "a_w", "a_n", "a_s", "a_p", "src", "a_p_un", "src_un", "theta", "delta",
         "sigma1", "x_star", "r")
LAUNCHES = 0  # kernel launches since the last reset (the CPU path never counts)
BATCH_LAUNCHES = 0  # the batched entry's


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
    residual norm).  Under ``torch.func.vmap`` the call is
    :class:`_ChebyCases`' batching rule's."""
    global LAUNCHES
    if _cuda.under_vmap():
        scalars = [s if torch.is_tensor(s) else torch.tensor(float(s), device=x0.device)
                   for s in (theta, delta, sigma1)]
        return _ChebyCases.apply(*_arrays(x0, c_rel, c_un), *scalars, degree)
    if not x0.is_cuda:
        return chebyshev_momentum_strips_plain(x0, c_rel, c_un, theta=theta, delta=delta,
                                               sigma1=sigma1, degree=degree)
    ni, nj = x0.shape
    if degree < 1 or degree + 1 > H:
        raise ValueError(f"degree {degree}: the kernel needs 1 <= degree <= {H - 1}")
    arrays = _arrays(x0, c_rel, c_un)
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


def _arrays(x0, c_rel, c_un):
    """The input arrays in the C entry's slot order."""
    return (x0, c_rel.a_e, c_rel.a_w, c_rel.a_n, c_rel.a_s, c_rel.a_p, c_rel.src,
            c_un.a_p, c_un.src)


# ---------------------------------------------------------------------------
# The case axis: B fields of one shape in one launch, the persistent blocks
# walking (case, tile) items; each case bit-equal to its single launch.


def _systems(arrays):
    """``(x0, c_rel, c_un)`` from the nine arrays of :func:`_arrays` (the
    unrelaxed set's links are the relaxed set's: only a_p and src differ)."""
    x0, ae, aw, an, as_, ap, src, ap_un, src_un = arrays
    c_rel = StencilCoeffs(a_e=ae, a_w=aw, a_n=an, a_s=as_, a_p=ap, src=src)
    return x0, c_rel, c_rel.replace(a_p=ap_un, src=src_un)


def chebyshev_momentum_strips_batched_plain(x0, c_rel, c_un, *, theta, delta, sigma1,
                                            degree: int, active=None):
    """The batched K9's plain version (the CPU path and its oracle): case by
    case through :func:`chebyshev_momentum_strips_plain` with each case's
    interval scalars; a frozen case (``active`` False) gets ``x0`` and a
    zero residual."""
    outs = []
    for k, on in enumerate(_cuda.case_flags(active, x0.shape[0])):
        if on:
            xk, ck_rel, ck_un = _systems([a[k] for a in _arrays(x0, c_rel, c_un)])
            outs.append(chebyshev_momentum_strips_plain(
                xk, ck_rel, ck_un, theta=theta[k], delta=delta[k], sigma1=sigma1[k],
                degree=degree))
        else:
            outs.append((x0[k], torch.zeros_like(x0[k])))
    return torch.stack([x for x, _ in outs]), torch.stack([r for _, r in outs])


class _BatchLaunch:
    """The batched entry's host arrays for one (device, stream, cases, shape,
    degree): the pointer slots (the single entry's 14, the active flags,
    then each slot's case stride; the outputs' strides filled once), the
    parameters with the case count, and the flags of a batch with no frozen
    case."""

    def __init__(self, ni, nj, degree, cases, dev):
        self.half = len(SLOTS) + 1
        self.ptrs = (ctypes.c_longlong * (2 * self.half))()
        self.ptrs[self.half + 12:self.half + 14] = [4 * ni * nj] * 2
        self.ip = (ctypes.c_int * 4)(ni, nj, degree, cases)
        self.ones = torch.ones(cases, dtype=torch.bool, device=dev)


_BATCH = {}


def chebyshev_momentum_strips_batched(x0, c_rel, c_un, *, theta, delta, sigma1, degree: int,
                                      active=None):
    """:func:`chebyshev_momentum_strips` of B fields of one shape in one
    launch: ``x0`` and the coefficient arrays carry a leading case axis
    (each case's slice contiguous; a case stride of 0 shares one array),
    ``theta``, ``delta``, ``sigma1`` float32 (B,) tensors (each case's own;
    stride 0: shared), ``active`` (B,) bool: a frozen case gets ``x0`` and a
    zero residual (None: every case active).  Returns ``(x_star, r_m)``
    (B, ni, nj) each, halves of one fresh buffer."""
    global BATCH_LAUNCHES
    if not x0.is_cuda:
        return chebyshev_momentum_strips_batched_plain(
            x0, c_rel, c_un, theta=theta, delta=delta, sigma1=sigma1, degree=degree,
            active=active)
    cases, ni, nj = x0.shape
    if degree < 1 or degree + 1 > H:
        raise ValueError(f"degree {degree}: the kernel needs 1 <= degree <= {H - 1}")
    f32 = torch.float32
    dev, stream = x0.device, _cuda.stream_of(x0)
    key = (dev, stream, cases, ni, nj, degree)
    st = _BATCH.get(key)
    if st is None:
        if len(_BATCH) >= 32:
            _BATCH.clear()
        st = _BATCH[key] = _BatchLaunch(ni, nj, degree, cases, dev)
    _cuda.case_slots(st, [(_arrays(x0, c_rel, c_un), (ni, nj)), ((theta, delta, sigma1), ())],
                     active, cases, "chebyshev_momentum_strips")
    out = torch.empty((2, cases, ni, nj), dtype=f32, device=dev)  # x* and r, one allocation
    st.ptrs[12:14] = [out[0].data_ptr(), out[1].data_ptr()]
    _cuda.check(_cuda.library().nf_chebyshev_strips_batched(st.ptrs, st.ip, _FP, stream),
                "chebyshev_momentum_strips_batched")
    BATCH_LAUNCHES += 1
    return out[0], out[1]


class _ChebyCases(torch.autograd.Function):
    """K9's batching rule: under ``torch.func.vmap`` every case's field goes
    into one :func:`chebyshev_momentum_strips_batched` launch with its own
    interval scalars and the active flags of ``_cuda.case_mask``; an operand
    shared by every case gets case stride 0."""

    generate_vmap_rule = False

    @staticmethod
    def forward(*args):
        *arrays, theta, delta, sigma1, degree = args
        return chebyshev_momentum_strips(*_systems(arrays), theta=theta, delta=delta,
                                         sigma1=sigma1, degree=degree)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        cases = info.batch_size
        *tensors, degree = args
        tensors = [_cuda.case_first(a, d, cases) for a, d in zip(tensors, in_dims)]
        theta, delta, sigma1 = tensors[9:]
        out = chebyshev_momentum_strips_batched(
            *_systems(tensors[:9]), theta=theta, delta=delta, sigma1=sigma1, degree=degree,
            active=_cuda.active_cases(cases))
        return out, (0, 0)
