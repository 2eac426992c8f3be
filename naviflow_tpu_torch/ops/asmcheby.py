"""K1: merged assembly + lagged-bound Chebyshev momentum solve of both fields.

Replaces ``naviflow_tpu/ops/pallas_asmcheby.py:fused_asmcheby_pair``; the
CUDA kernel is ``csrc/asmcheby.cuh`` (its header says what bounds it on the
H100 and how its persistent 2-D halo tiles deal with that), its entry
points ``csrc/asmcheby.cu`` and, with phase timers,
``csrc/asmcheby_phases.cu``.

One call assembles each field's power-law coefficients, relaxes them, runs
``degree`` Chebyshev steps with the given (lagged) interval scalars,
evaluates the unrelaxed residual, and folds out d_u / d_v, the 5-array
pressure-correction operator and each field's fresh masked Gershgorin ratio
maximum (the next outer step's bounds).  The first step uses the
conservative ``rho = 0.999`` (``algorithms/simple.py``).

On a CPU tensor :func:`fused_asmcheby_pair` runs
:func:`fused_asmcheby_pair_plain`, the composed PyTorch version; on a CUDA
tensor it launches the kernel or raises.  A launch allocates one buffer for
all its outputs and runs no other PyTorch operator: the interval scalars
are read by address, and the Gershgorin maxima come out of the kernel.

The case axis (:func:`fused_asmcheby_pair_batched`): B cases of one shape
in one launch, each with its own fields, conductance row
(``powerlaw.case_conductances``) and interval scalars, each bit-equal to
its single launch.  Under ``torch.func.vmap`` (alone)
:func:`fused_asmcheby_pair` is its batching rule's entry.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _cuda
from .poisson import PoissonCoeffs, poisson_coefficients
from .powerlaw import (case_conductances, d_coefficient, relax_coefficients,
                       u_momentum_coefficients, v_momentum_coefficients)
from .stencil import apply_stencil

PAD = 16  # the TPU window halo: the gate keeps degree + 1 <= PAD

# The TPU kernel's window cap in cells (a VMEM budget), kept so the port
# admits exactly the grids the reference admits; not an H100 limit.
_CAP_CELLS = 224 * 1024

_VARIANTS = {"consistent": 0, "symmetric": 1, "reference": 2}

# csrc/asmcheby.cuh's launch shape: persistent blocks of 512 threads, one
# an SM, over regions of 64 x 64 faces (an owned tile and a halo of
# degree + 1 on every side)
THREADS = 512
RI = RJ = 64


def tile_shape(degree: int):
    """The owned tile of a region at ``degree``: (rows, columns)."""
    return RI - 2 * (degree + 1), RJ - 2 * (degree + 1)


def smem_bytes() -> int:
    """Dynamic shared memory of one block: the two iterate buffers (a zero
    border) and eight region arrays."""
    return 4 * (2 * (RI + 2) * (RJ + 2) + 8 * RI * RJ)


# the C entry's pointer slots, in its order (csrc/asmcheby.cuh launch_asmcheby)
SLOTS = ("u", "v", "p", "theta_u", "delta_u", "sigma1_u", "theta_v", "delta_v", "sigma1_v",
         "u_star", "r_u", "v_star", "r_v", "d_u", "d_v", "pe", "pw", "pn", "ps", "pdiag",
         "gmax")
N_IN = 9  # the slots before the outputs
# the timed instantiation's phases (csrc/asmcheby.cuh K1Phase); its timer
# buffer holds the summed ns of each, then each one's count, then the last stamp
PHASE_NAMES = ("assembly", "chebyshev", "residual", "pressure")
N_TIMERS = 2 * len(PHASE_NAMES) + 1
_ALIGN = 64  # floats: every output starts on a 256-byte boundary of the one buffer


def output_layout(nx: int, ny: int):
    """``[(offset, shape)]`` of each output in the one buffer, in SLOTS'
    order from ``u_star``; the buffer's length last."""
    shapes = ([(nx + 1, ny)] * 2 + [(nx, ny + 1)] * 2 + [(nx + 1, ny), (nx, ny + 1)]
              + [(nx, ny)] * 5 + [(2,)])
    out, off = [], 0
    for shape in shapes:
        out.append((off, shape))
        off += -(-math.prod(shape) // _ALIGN) * _ALIGN
    return out, off


class _Launch:
    """The host arrays of one (device, stream, shape, degree, variant,
    physics) launch: the pointer slots (inputs refilled per call), the
    integer and float parameters, the output layout."""

    def __init__(self, nx, ny, degree, variant, floats):
        self.layout, self.total = output_layout(nx, ny)
        self.ptrs = (ctypes.c_longlong * (len(SLOTS) + 1))()  # + the timer buffer
        self.ip = (ctypes.c_int * 4)(nx, ny, degree, variant)
        self.fp = (ctypes.c_float * 9)(*floats)


_LAUNCH = {}

LAUNCHES = 0  # kernel launches since the last reset (the CPU path never counts)
BATCH_LAUNCHES = 0  # the batched entry's


def _strip_rows_merged(nx: int, ny: int) -> int:
    for T in (128, 64, 32, 16):
        if nx % T == 0 and (T + 2 * PAD) * ny <= _CAP_CELLS:
            return T
    return 0


def supports_asmcheby(nx, ny, scheme, dtype, backend, degree, device) -> bool:
    """Gate: kernel backend on a CUDA device, power-law f32 five-point
    systems, nx, ny >= 1024 (the reference's measured crossover), the apply
    chain within the halo."""
    if backend not in ("auto", "kernel") or not _cuda.kernel_device(device):
        return False
    if scheme != "power_law" or dtype != torch.float32:
        return False
    if degree + 1 > PAD:
        return False
    if nx < 1024 or ny < 1024:
        return False
    return _strip_rows_merged(nx, ny) > 0


def _masked_ratio_max(c_rel, mask):
    safe = torch.where(c_rel.a_p == 0, torch.ones_like(c_rel.a_p), c_rel.a_p)
    nb = (torch.abs(c_rel.a_e) + torch.abs(c_rel.a_w)
          + torch.abs(c_rel.a_n) + torch.abs(c_rel.a_s))
    return torch.max(torch.where(mask, nb / safe, torch.zeros_like(nb)))


def fused_asmcheby_pair_plain(u, v, p, *, dx, dy, rho, mu, alpha, degree,
                              bounds_u, bounds_v, poisson_variant="consistent"):
    """The composed version: global assembly -> relax -> Chebyshev with the
    given bounds -> masked unrelaxed residual -> d -> pressure operator ->
    masked Gershgorin ratio maxima."""
    from ..solvers.momentum import (_chebyshev_iterate, _u_interior_mask,
                                    _v_interior_mask)

    kw = dict(dx=dx, dy=dy, rho=rho, mu=mu)
    cu = u_momentum_coefficients(u, v, p, **kw)
    cu_rel = relax_coefficients(cu, u, alpha)
    cv = v_momentum_coefficients(u, v, p, **kw)
    cv_rel = relax_coefficients(cv, v, alpha)
    mask_u = _u_interior_mask(u.shape, device=u.device)
    mask_v = _v_interior_mask(v.shape, device=v.device)
    x_u = _chebyshev_iterate(u, cu_rel, mask_u, *bounds_u, degree)
    x_v = _chebyshev_iterate(v, cv_rel, mask_v, *bounds_v, degree)
    r_u = torch.where(mask_u, cu.src - apply_stencil(x_u, cu), torch.zeros_like(x_u))
    r_v = torch.where(mask_v, cv.src - apply_stencil(x_v, cv), torch.zeros_like(x_v))
    d_u = d_coefficient(cu_rel.a_p, dy, is_u=True)
    d_v = d_coefficient(cv_rel.a_p, dx, is_u=False)
    pc = poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho, variant=poisson_variant)
    return (x_u, r_u, x_v, r_v, d_u, d_v, pc,
            _masked_ratio_max(cu_rel, mask_u), _masked_ratio_max(cv_rel, mask_v))


def _floats(dx, dy, rho, mu, alpha):
    """The C entry's float parameters; ``mu`` a number, or one case's
    ``powerlaw.case_conductances`` row (its De and Dn, which round as the
    number's do)."""
    if torch.is_tensor(mu):
        de, dn = float(mu[0]), float(mu[1])
    else:
        de, dn = mu * dy / dx, mu * dx / dy
    return (0.5 * rho * dy, 0.5 * rho * dx, de, dn, dx, dy, alpha, 1.0 - alpha, rho)


def _check_args(degree, poisson_variant):
    if degree < 1 or degree + 1 > PAD:
        raise ValueError(f"degree {degree}: the kernel needs 1 <= degree <= {PAD - 1}")
    if poisson_variant not in _VARIANTS:
        raise ValueError(f"Unknown poisson operator variant: {poisson_variant}")


def _launch(u, v, p, dx, dy, rho, mu, alpha, degree, bounds_u, bounds_v, poisson_variant,
            timers=None):
    nxp1, ny = u.shape
    nx = nxp1 - 1
    _cuda.require_all((u,), (nx + 1, ny), "u")
    _cuda.require_all((v,), (nx, ny + 1), "v")
    _cuda.require_all((p,), (nx, ny), "p")
    _check_args(degree, poisson_variant)
    dev, stream = u.device, _cuda.stream_of(u)
    floats = _floats(dx, dy, rho, mu, alpha)
    key = (dev, stream, nx, ny, degree, poisson_variant, floats)
    st = _LAUNCH.get(key)
    if st is None:
        if len(_LAUNCH) >= 32:
            _LAUNCH.clear()
        st = _LAUNCH[key] = _Launch(nx, ny, degree, _VARIANTS[poisson_variant], floats)
    scalars, held = _cuda.scalar_ptrs((*bounds_u, *bounds_v), dev)  # held until enqueued
    buf = torch.empty(st.total, dtype=torch.float32, device=dev)  # every output
    base = buf.data_ptr()
    ptrs = st.ptrs
    ptrs[:N_IN] = [u.data_ptr(), v.data_ptr(), p.data_ptr(), *scalars]
    ptrs[N_IN:len(SLOTS)] = [base + 4 * off for off, _ in st.layout]
    entry = "nf_asmcheby_pair"
    if timers is not None:
        ptrs[len(SLOTS)] = timers.data_ptr()
        entry = "nf_asmcheby_pair_phases"
    _cuda.check(getattr(_cuda.library(), entry)(ptrs, st.ip, st.fp, stream), entry)
    outs = [buf.as_strided(shape, (shape[1], 1), off) for off, shape in st.layout[:-1]]
    g = st.layout[-1][0]
    u_star, r_u, v_star, r_v, d_u, d_v, pe, pw, pn, ps, pdiag = outs
    pc = PoissonCoeffs(a_e=pe, a_w=pw, a_n=pn, a_s=ps, diag=pdiag)
    return (u_star, r_u, v_star, r_v, d_u, d_v, pc, buf.as_strided((), (), g),
            buf.as_strided((), (), g + 1))


def fused_asmcheby_pair(u, v, p, *, dx, dy, rho, mu, alpha, degree,
                        bounds_u, bounds_v, poisson_variant="consistent"):
    """Assemble + Chebyshev-solve both momentum fields in one launch.

    ``u, v``: BC-applied staggered fields; ``bounds_u``/``bounds_v``:
    ``(theta, delta, sigma1)`` interval scalars (0-d tensors on the card, or
    numbers).  Returns ``(u_star, r_u, v_star, r_v, d_u, d_v, pc, rho_u,
    rho_v)``: the ``r`` fields are the unrelaxed residuals, zero outside
    each field's solve mask, ``pc`` the :class:`PoissonCoeffs`, and
    ``rho_u/rho_v`` the fresh masked Gershgorin ratio maxima (0-d tensors).
    On the card every output is a view of one fresh buffer.  ``mu`` is a
    number or (the vmapped batch step) one case's conductance row
    (``powerlaw.case_conductances``); under ``torch.func.vmap`` the call is
    :class:`_AsmChebyCases`' batching rule's."""
    global LAUNCHES
    if _cuda.under_vmap():
        if not torch.is_tensor(mu):
            mu = case_conductances([mu], dx, dy, torch.float32, u.device)[0]
        scalars = [s if torch.is_tensor(s) else torch.tensor(float(s), device=u.device)
                   for s in (*bounds_u, *bounds_v)]
        out = _AsmChebyCases.apply(u, v, p, mu, *scalars,
                                   (dx, dy, rho, alpha, degree, poisson_variant))
        return _unflatten(out)
    if not u.is_cuda:
        return fused_asmcheby_pair_plain(
            u, v, p, dx=dx, dy=dy, rho=rho, mu=mu, alpha=alpha, degree=degree,
            bounds_u=bounds_u, bounds_v=bounds_v, poisson_variant=poisson_variant)
    out = _launch(u, v, p, dx, dy, rho, mu, alpha, degree, bounds_u, bounds_v,
                  poisson_variant)
    LAUNCHES += 1
    return out


def decode_phases(buf):
    """The timer buffer of ``nf_asmcheby_pair_phases`` (per phase the summed
    ns, then per phase the count, then the last stamp) as ``{name: (ms,
    count)}``."""
    vals = [int(x) for x in buf]
    n = len(PHASE_NAMES)
    if len(vals) != N_TIMERS:
        raise ValueError(f"expected {N_TIMERS} timer slots, got {len(vals)}")
    return {name: (vals[k] / 1e6, vals[n + k]) for k, name in enumerate(PHASE_NAMES)}


def fused_asmcheby_pair_phases(u, v, p, *, dx, dy, rho, mu, alpha, degree,
                               bounds_u, bounds_v, poisson_variant="consistent"):
    """:func:`fused_asmcheby_pair` through the instantiation with phase
    timers (``nf_asmcheby_pair_phases``; thread 0 of block 0 stamps
    %globaltimer after each phase of each of its tiles), a measurement aid:
    CUDA tensors only, not counted in ``LAUNCHES``.  Returns the outputs and
    :func:`decode_phases` of the timers (after a synchronise)."""
    timers = torch.zeros(N_TIMERS, dtype=torch.int64, device=u.device)
    out = _launch(u, v, p, dx, dy, rho, mu, alpha, degree, bounds_u, bounds_v,
                  poisson_variant, timers)
    return out, decode_phases(timers.cpu())


# ---------------------------------------------------------------------------
# The case axis: B cases of one shape in one launch, the persistent blocks
# walking (case, tile) items; each case bit-equal to its single launch.


def _unflatten(out):
    """The 13 flat outputs as :func:`fused_asmcheby_pair` returns them."""
    u_star, r_u, v_star, r_v, d_u, d_v, pe, pw, pn, ps, pdiag, rho_u, rho_v = out
    return (u_star, r_u, v_star, r_v, d_u, d_v,
            PoissonCoeffs(a_e=pe, a_w=pw, a_n=pn, a_s=ps, diag=pdiag), rho_u, rho_v)


def _flat(out):
    pc = out[6]
    return (*out[:6], pc.a_e, pc.a_w, pc.a_n, pc.a_s, pc.diag, out[7], out[8])


def fused_asmcheby_pair_batched_plain(u, v, p, *, dx, dy, rho, visc, alpha, degree, bounds_u,
                                      bounds_v, poisson_variant="consistent", active=None):
    """The batched K1's plain version (the CPU path and its oracle): case by
    case through :func:`fused_asmcheby_pair_plain` with each case's
    conductance row and interval scalars; a frozen case (``active`` False)
    gets its u and v back and zeros in every other output."""
    outs = []
    for k, on in enumerate(_cuda.case_flags(active, u.shape[0])):
        if on:
            outs.append(_flat(fused_asmcheby_pair_plain(
                u[k], v[k], p[k], dx=dx, dy=dy, rho=rho, mu=visc[k], alpha=alpha,
                degree=degree, bounds_u=tuple(s[k] for s in bounds_u),
                bounds_v=tuple(s[k] for s in bounds_v), poisson_variant=poisson_variant)))
        else:
            zero = u.new_zeros(())
            outs.append((u[k], torch.zeros_like(u[k]), v[k], torch.zeros_like(v[k]),
                         torch.zeros_like(u[k]), torch.zeros_like(v[k]),
                         *[torch.zeros_like(p[k])] * 5, zero, zero))
    return _unflatten([torch.stack(xs) for xs in zip(*outs)])


class _BatchLaunch:
    """The batched entry's host arrays for one (device, stream, cases,
    shape, degree, variant, physics): the pointer slots (the single entry's
    21, the conductances, the active flags, then each slot's case stride;
    the outputs' strides filled once), the parameters with the case count,
    the output layout of one case, and the flags of a batch with no frozen
    case."""

    def __init__(self, nx, ny, degree, variant, floats, cases, dev):
        self.layout, self.total = output_layout(nx, ny)
        self.half = len(SLOTS) + 2
        self.ptrs = (ctypes.c_longlong * (2 * self.half))()
        self.ptrs[self.half + N_IN:self.half + len(SLOTS)] = [4 * self.total] * (len(SLOTS) - N_IN)
        self.ip = (ctypes.c_int * 5)(nx, ny, degree, variant, cases)
        self.fp = (ctypes.c_float * 9)(*floats)
        self.ones = torch.ones(cases, dtype=torch.bool, device=dev)


_BATCH = {}


def fused_asmcheby_pair_batched(u, v, p, *, dx, dy, rho, visc, alpha, degree, bounds_u,
                                bounds_v, poisson_variant="consistent", active=None):
    """:func:`fused_asmcheby_pair` of B cases of one shape in one launch:
    ``u``, ``v``, ``p`` carry a leading case axis (each case's slice
    contiguous; a case stride of 0 shares one array), ``visc`` (B, 4) each
    case's conductances (``powerlaw.case_conductances``), ``bounds_u`` /
    ``bounds_v`` three float32 (B,) tensors each (theta, delta, sigma1 of
    each case), ``active`` (B,) bool: a frozen case gets its u and v back
    and zeros elsewhere (None: every case active).  Returns the single
    call's outputs with the case axis first, views of one fresh buffer."""
    global BATCH_LAUNCHES
    if not u.is_cuda:
        return fused_asmcheby_pair_batched_plain(
            u, v, p, dx=dx, dy=dy, rho=rho, visc=visc, alpha=alpha, degree=degree,
            bounds_u=bounds_u, bounds_v=bounds_v, poisson_variant=poisson_variant,
            active=active)
    cases, nxp1, ny = u.shape
    nx = nxp1 - 1
    _check_args(degree, poisson_variant)
    f32 = torch.float32
    dev, stream = u.device, _cuda.stream_of(u)
    floats = (0.5 * rho * dy, 0.5 * rho * dx, 0.0, 0.0, dx, dy, alpha, 1.0 - alpha, rho)
    key = (dev, stream, cases, nx, ny, degree, poisson_variant, floats)
    st = _BATCH.get(key)
    if st is None:
        if len(_BATCH) >= 32:
            _BATCH.clear()
        st = _BATCH[key] = _BatchLaunch(nx, ny, degree, _VARIANTS[poisson_variant], floats,
                                        cases, dev)
    ptrs, half, n = st.ptrs, st.half, len(SLOTS)
    _cuda.case_slots(st, [([u], (nx + 1, ny)), ([v], (nx, ny + 1)), ([p], (nx, ny)),
                          ([*bounds_u, *bounds_v], ())], active, cases, "fused_asmcheby_pair")
    buf = torch.empty((cases, st.total), dtype=f32, device=dev)  # every output
    base = buf.data_ptr()
    ptrs[N_IN:n] = [base + 4 * off for off, _ in st.layout]
    ptrs[n], ptrs[half + n] = visc.data_ptr(), _cuda.case_stride(visc, cases, (4,), f32, "visc")
    _cuda.check(_cuda.library().nf_asmcheby_pair_batched(ptrs, st.ip, st.fp, stream),
                "fused_asmcheby_pair_batched")
    BATCH_LAUNCHES += 1
    outs = [buf.as_strided((cases, *shape), (st.total, shape[1], 1), off)
            for off, shape in st.layout[:-1]]
    g = st.layout[-1][0]
    return _unflatten([*outs, buf.as_strided((cases,), (st.total,), g),
                       buf.as_strided((cases,), (st.total,), g + 1)])


class _AsmChebyCases(torch.autograd.Function):
    """K1's batching rule: under ``torch.func.vmap`` every case's call goes
    into one :func:`fused_asmcheby_pair_batched` launch with its own
    conductance row and interval scalars and the active flags of
    ``_cuda.case_mask``; an operand shared by every case gets case stride
    0."""

    generate_vmap_rule = False

    @staticmethod
    def forward(u, v, p, visc, *args):
        *scalars, (dx, dy, rho, alpha, degree, variant) = args
        return _flat(fused_asmcheby_pair(u, v, p, dx=dx, dy=dy, rho=rho, mu=visc, alpha=alpha,
                                         degree=degree, bounds_u=tuple(scalars[:3]),
                                         bounds_v=tuple(scalars[3:]),
                                         poisson_variant=variant))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *args):
        cases = info.batch_size
        *arrays, (dx, dy, rho, alpha, degree, variant) = args
        u, v, p, visc, *scalars = (_cuda.case_first(a, d, cases)
                                   for a, d in zip(arrays, in_dims[:len(arrays)]))
        out = fused_asmcheby_pair_batched(
            u, v, p, dx=dx, dy=dy, rho=rho, visc=visc, alpha=alpha, degree=degree,
            bounds_u=tuple(scalars[:3]), bounds_v=tuple(scalars[3:]), poisson_variant=variant,
            active=_cuda.active_cases(cases))
        flat = _flat(out)
        return flat, (0,) * len(flat)
