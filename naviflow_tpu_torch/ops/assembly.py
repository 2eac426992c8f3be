"""K8: both momentum fields' coefficient sets in one pass over u, v, p.

Replaces ``naviflow_tpu/ops/pallas_assembly.py:fused_assembly_pair``; the
CUDA kernel is ``csrc/assembly.cu`` (its header says what bounds it on the
H100 and how the design meets it).

One call assembles the power-law coefficients of both fields, relaxes them,
and folds out each field's masked Gershgorin ratio maximum and, with a
Poisson variant, d_u, d_v and the pressure-correction operator.  It runs
where the large-grid momentum solves do not go through the merged kernel K1
(SIMPLEC, PISO, SIMPLER, and SIMPLE with Jacobi or BiCGSTAB momentum).

On a CPU tensor :func:`fused_assembly_pair` runs
:func:`fused_assembly_pair_plain`, the composed PyTorch version; on a CUDA
tensor it launches the kernel or raises.  A launch allocates one buffer
for all its outputs (:func:`output_layout`) and runs no other PyTorch
operator: the Gershgorin maxima come out of the kernel.

The case axis (:func:`fused_assembly_pair_batched`): B cases of one shape
in one launch, the persistent blocks walking (case, tile) items, each case
with its own fields and conductance row (``powerlaw.case_conductances``),
each bit-equal to its single launch.  Under ``torch.func.vmap`` (alone)
:func:`fused_assembly_pair` is its batching rule's entry.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _cuda
from .asmcheby import _floats, _masked_ratio_max
from .poisson import PoissonCoeffs, poisson_coefficients
from .powerlaw import (case_conductances, d_coefficient, relax_coefficients,
                       u_momentum_coefficients, v_momentum_coefficients)
from .stencil import StencilCoeffs

# The TPU kernel's folded-window cap in cells and its halo rows (a VMEM
# budget), kept so the port admits exactly the grids the reference admits;
# not an H100 limit.
_PAD = 16
_CAP_CELLS_FOLDED = 280 * 1024

_VARIANTS = {"consistent": 0, "symmetric": 1, "reference": 2}
_ALIGN = 64  # floats: every output starts on a 256-byte boundary of the one buffer

LAUNCHES = 0  # kernel launches since the last reset (the CPU path never counts)
BATCH_LAUNCHES = 0  # the batched entry's


def supports_fused_assembly(nx, ny, scheme, dtype, backend, device) -> bool:
    """Gate (``pallas_assembly.supports_fused_assembly``): the kernel backend
    on a CUDA device, power-law f32, grids of at least 384 x 256 whose
    folded strip window fits the reference's budget."""
    if backend not in ("auto", "kernel") or not _cuda.kernel_device(device):
        return False
    if scheme != "power_law" or dtype != torch.float32:
        return False
    if nx < 384 or ny < 256:
        return False
    return any(nx % T == 0 and (T + 2 * _PAD) * ny <= _CAP_CELLS_FOLDED
               for T in (128, 64, 32, 16))


def _result(cu_un, cu_rel, cv_un, cv_rel, rho_u, rho_v, fold, with_bounds):
    out = (cu_un, cu_rel, cv_un, cv_rel)
    if with_bounds:
        out = out + (rho_u, rho_v)
    if fold is not None:
        out = out + fold
    return out


def fused_assembly_pair_plain(u, v, p, *, dx, dy, rho, mu, alpha, with_bounds=False,
                              poisson_variant=None):
    """The composed version: global assembly -> relax -> masked Gershgorin
    ratio maxima -> d -> pressure operator."""
    from ..solvers.momentum import _u_interior_mask, _v_interior_mask

    kw = dict(dx=dx, dy=dy, rho=rho, mu=mu)
    cu_un = u_momentum_coefficients(u, v, p, **kw)
    cu_rel = relax_coefficients(cu_un, u, alpha)
    cv_un = v_momentum_coefficients(u, v, p, **kw)
    cv_rel = relax_coefficients(cv_un, v, alpha)
    rho_u = rho_v = fold = None
    if with_bounds:
        rho_u = _masked_ratio_max(cu_rel, _u_interior_mask(u.shape, device=u.device))
        rho_v = _masked_ratio_max(cv_rel, _v_interior_mask(v.shape, device=v.device))
    if poisson_variant is not None:
        d_u = d_coefficient(cu_rel.a_p, dy, is_u=True)
        d_v = d_coefficient(cv_rel.a_p, dx, is_u=False)
        fold = (d_u, d_v, poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho,
                                               variant=poisson_variant))
    return _result(cu_un, cu_rel, cv_un, cv_rel, rho_u, rho_v, fold, with_bounds)


def output_groups(nx: int, ny: int, fold: bool):
    """The one output buffer's groups, ``[(offset, count, shape, pitch)]``:
    the u arrays (the eight coefficient arrays, then with the fold d_u),
    the v arrays (likewise d_v), with the fold the pressure operator's five,
    then the two maxima; each array on a 256-byte boundary, the arrays of a
    group ``pitch`` floats apart.  The buffer's length in floats last."""
    u, v, c = (nx + 1, ny), (nx, ny + 1), (nx, ny)
    groups, off = [], 0
    for count, shape in ((8 + fold, u), (8 + fold, v), (5 * fold, c), (1, (2,))):
        if count:
            pitch = -(-math.prod(shape) // _ALIGN) * _ALIGN
            groups.append((off, count, shape, pitch))
            off += count * pitch
    return groups, off


def output_layout(nx: int, ny: int, fold: bool):
    """``[(offset, shape)]`` of each output in the C entry's slot order
    (the 16 coefficient arrays, the maxima pair, with the fold d_u, d_v and
    the operator's five arrays), as :func:`output_groups` lays them out;
    the buffer's length in floats last."""
    groups, total = output_groups(nx, ny, fold)

    def at(g, k):
        off, _, shape, pitch = groups[g]
        return off + k * pitch, shape

    slots = [at(0, k) for k in range(8)] + [at(1, k) for k in range(8)] + [at(-1, 0)]
    if fold:
        slots += [at(0, 8), at(1, 8)] + [at(2, k) for k in range(5)]
    return slots, total


def _outputs(buf, groups, cases=None):
    """The views of one buffer (``cases``: a buffer of case layouts, the case
    axis first): the u arrays, the v arrays, with the fold the operator's
    five, and the maxima pair, each group in one ``as_strided`` and
    ``unbind``."""
    lead, step = ((), ()) if cases is None else ((cases,), (buf.shape[1],))
    out = []
    for off, count, shape, pitch in groups:
        if shape == (2,):
            out.append(buf.as_strided((*lead, 2), (*step, 1), off).unbind(-1))
        else:
            out.append(buf.as_strided((*lead, count, *shape), (*step, pitch, shape[1], 1),
                                      off).unbind(len(lead)))
    return out


def _result_of(outs, with_bounds, fold):
    """:func:`fused_assembly_pair`'s result from :func:`_outputs`' views (the
    relaxed sets share the unrelaxed links)."""
    ua, va, *rest = outs
    rho_u = rho_v = pc = None
    if with_bounds:
        rho_u, rho_v = rest[-1]
    if fold:
        pc = (ua[8], va[8], PoissonCoeffs(*rest[0]))
    return _result(StencilCoeffs(*ua[:6]), StencilCoeffs(*ua[:4], ua[6], ua[7]),
                   StencilCoeffs(*va[:6]), StencilCoeffs(*va[:4], va[6], va[7]),
                   rho_u, rho_v, pc, with_bounds)


class _Launch:
    """The host arrays of one (device, stream, shape, variant, bounds,
    physics) launch: the pointer slots (u, v, p and the outputs refilled
    per call), the integer and float parameters, the output groups and the
    slots' offsets in bytes."""

    def __init__(self, nx, ny, variant, bounds, floats):
        self.groups, self.total = output_groups(nx, ny, variant >= 0)
        layout, _ = output_layout(nx, ny, variant >= 0)
        self.offsets = [4 * off for off, _ in layout]
        self.ptrs = (ctypes.c_longlong * (3 + len(layout)))()
        self.ip = (ctypes.c_int * 4)(nx, ny, variant, int(bounds))
        self.fp = (ctypes.c_float * 9)(*floats)


_LAUNCH = {}


def fused_assembly_pair(u, v, p, *, dx, dy, rho, mu, alpha, with_bounds=False,
                        poisson_variant=None):
    """Both momentum fields' (unrelaxed, relaxed) coefficient sets in one
    launch.  ``u, v``: the BC-applied staggered fields.  Returns ``(cu_un,
    cu_rel, cv_un, cv_rel)`` (:class:`StencilCoeffs`, the relaxed sets
    sharing the unrelaxed links), then ``(rho_u, rho_v)`` (0-d tensors, the
    masked Gershgorin ratio maxima of the relaxed systems) when
    ``with_bounds``, then ``(d_u, d_v, pc)`` when ``poisson_variant`` is
    set ('consistent', 'symmetric' or 'reference').  On the card every
    output is a view of one fresh buffer.  ``mu`` is a number or (the
    vmapped batch step) one case's conductance row
    (``powerlaw.case_conductances``); under ``torch.func.vmap`` the call is
    :class:`_AssemblyCases`' batching rule's."""
    global LAUNCHES
    if poisson_variant is not None and poisson_variant not in _VARIANTS:
        raise ValueError(f"Unknown poisson operator variant: {poisson_variant}")
    if _cuda.under_vmap():
        if not torch.is_tensor(mu):
            mu = case_conductances([mu], dx, dy, torch.float32, u.device)[0]
        out = _AssemblyCases.apply(u, v, p, mu, (dx, dy, rho, alpha, bool(with_bounds),
                                                 poisson_variant))
        return _unflatten(out, with_bounds, poisson_variant)
    if not u.is_cuda:
        return fused_assembly_pair_plain(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu, alpha=alpha,
                                         with_bounds=with_bounds,
                                         poisson_variant=poisson_variant)
    nxp1, ny = u.shape
    nx = nxp1 - 1
    _cuda.require_all((u,), (nx + 1, ny), "u")
    _cuda.require_all((v,), (nx, ny + 1), "v")
    _cuda.require_all((p,), (nx, ny), "p")
    dev, stream = u.device, _cuda.stream_of(u)  # raises under a transform
    variant = _VARIANTS[poisson_variant] if poisson_variant is not None else -1
    floats = _floats(dx, dy, rho, mu, alpha)
    key = (dev, stream, nx, ny, variant, bool(with_bounds), floats)
    st = _LAUNCH.get(key)
    if st is None:
        if len(_LAUNCH) >= 32:
            _LAUNCH.clear()
        st = _LAUNCH[key] = _Launch(nx, ny, variant, with_bounds, floats)
    buf = torch.empty(st.total, dtype=torch.float32, device=dev)  # every output
    base = buf.data_ptr()
    ptrs = st.ptrs
    ptrs[:3] = [u.data_ptr(), v.data_ptr(), p.data_ptr()]
    ptrs[3:] = [base + off for off in st.offsets]
    _cuda.check(_cuda.library().nf_fused_assembly_pair(ptrs, st.ip, st.fp, stream),
                "fused_assembly_pair")
    LAUNCHES += 1
    return _result_of(_outputs(buf, st.groups), with_bounds, variant >= 0)


# ---------------------------------------------------------------------------
# The case axis: B cases of one shape in one launch (the persistent blocks
# walk (case, tile) items), each case bit-equal to its single launch.

_COEF = ("a_e", "a_w", "a_n", "a_s", "a_p", "src")


def _flat(out, with_bounds, poisson_variant):
    """:func:`fused_assembly_pair`'s result as a flat tuple of tensors: each
    field's six unrelaxed arrays and its relaxed a_p and src, then the
    maxima, then d_u, d_v and the operator's five arrays."""
    cu_un, cu_rel, cv_un, cv_rel = out[:4]
    flat = tuple(getattr(cu_un, f) for f in _COEF) + (cu_rel.a_p, cu_rel.src)
    flat += tuple(getattr(cv_un, f) for f in _COEF) + (cv_rel.a_p, cv_rel.src)
    rest = out[4:]
    if with_bounds:
        flat += tuple(rest[:2])
        rest = rest[2:]
    if poisson_variant is not None:
        d_u, d_v, pc = rest
        flat += (d_u, d_v, pc.a_e, pc.a_w, pc.a_n, pc.a_s, pc.diag)
    return flat


def _unflatten(flat, with_bounds, poisson_variant):
    """The inverse of :func:`_flat`."""
    cu_un = StencilCoeffs(*flat[:6])
    cv_un = StencilCoeffs(*flat[8:14])
    rho_u = rho_v = fold = None
    rest = flat[16:]
    if with_bounds:
        (rho_u, rho_v), rest = rest[:2], rest[2:]
    if poisson_variant is not None:
        d_u, d_v, pe, pw, pn, ps, pdiag = rest
        fold = (d_u, d_v, PoissonCoeffs(a_e=pe, a_w=pw, a_n=pn, a_s=ps, diag=pdiag))
    return _result(cu_un, cu_un.replace(a_p=flat[6], src=flat[7]), cv_un,
                   cv_un.replace(a_p=flat[14], src=flat[15]), rho_u, rho_v, fold, with_bounds)


def fused_assembly_pair_batched_plain(u, v, p, *, dx, dy, rho, visc, alpha, with_bounds=False,
                                      poisson_variant=None, active=None):
    """The batched K8's plain version (the CPU path and its oracle): case by
    case through :func:`fused_assembly_pair_plain` with each case's
    conductance row; a frozen case (``active`` False) gets zeros in every
    output."""
    outs = []
    for k, on in enumerate(_cuda.case_flags(active, u.shape[0])):
        if on:
            outs.append(_flat(fused_assembly_pair_plain(
                u[k], v[k], p[k], dx=dx, dy=dy, rho=rho, mu=visc[k], alpha=alpha,
                with_bounds=with_bounds, poisson_variant=poisson_variant),
                with_bounds, poisson_variant))
        else:
            zu, zv, zp = (torch.zeros_like(x[k]) for x in (u, v, p))
            outs.append((zu,) * 8 + (zv,) * 8 + (u.new_zeros(()),) * (2 if with_bounds else 0)
                        + ((zu, zv) + (zp,) * 5 if poisson_variant is not None else ()))
    return _unflatten(tuple(torch.stack(xs) for xs in zip(*outs)), with_bounds,
                      poisson_variant)


class _BatchLaunch(_Launch):
    """The batched entry's host arrays for one (device, stream, cases,
    shape, variant, bounds, physics): :class:`_Launch`'s for one case, the
    pointer slots grown by the conductances, the active flags and each
    slot's case stride (the outputs' filled once), the case count after the
    parameters, and the flags of a batch with no frozen case."""

    def __init__(self, nx, ny, variant, bounds, floats, cases, dev):
        super().__init__(nx, ny, variant, bounds, floats)
        self.n = len(self.ptrs)
        self.half = self.n + 2
        self.ptrs = (ctypes.c_longlong * (2 * self.half))()
        self.ptrs[self.half + 3:self.half + self.n] = [4 * self.total] * (self.n - 3)
        self.ip = (ctypes.c_int * 5)(*self.ip, cases)
        self.ones = torch.ones(cases, dtype=torch.bool, device=dev)


_BATCH = {}


def fused_assembly_pair_batched(u, v, p, *, dx, dy, rho, visc, alpha, with_bounds=False,
                                poisson_variant=None, active=None):
    """:func:`fused_assembly_pair` of B cases of one shape in one launch:
    ``u``, ``v``, ``p`` carry a leading case axis (each case's slice
    contiguous; a case stride of 0 shares one array), ``visc`` (B, 4) each
    case's conductances (``powerlaw.case_conductances``), ``active`` (B,)
    bool: a frozen case gets zeros in every output (None: every case
    active).  Returns the single call's outputs with the case axis first
    (the maxima (B,)), views of one fresh buffer of case layouts."""
    global BATCH_LAUNCHES
    if poisson_variant is not None and poisson_variant not in _VARIANTS:
        raise ValueError(f"Unknown poisson operator variant: {poisson_variant}")
    if not u.is_cuda:
        return fused_assembly_pair_batched_plain(
            u, v, p, dx=dx, dy=dy, rho=rho, visc=visc, alpha=alpha, with_bounds=with_bounds,
            poisson_variant=poisson_variant, active=active)
    cases, nxp1, ny = u.shape
    nx = nxp1 - 1
    f32 = torch.float32
    dev, stream = u.device, _cuda.stream_of(u)
    variant = _VARIANTS[poisson_variant] if poisson_variant is not None else -1
    floats = _floats(dx, dy, rho, 0.0, alpha)
    key = (dev, stream, cases, nx, ny, variant, bool(with_bounds), floats)
    st = _BATCH.get(key)
    if st is None:
        if len(_BATCH) >= 32:
            _BATCH.clear()
        st = _BATCH[key] = _BatchLaunch(nx, ny, variant, with_bounds, floats, cases, dev)
    ptrs, half, n = st.ptrs, st.half, st.n
    _cuda.case_slots(st, [([u], (nx + 1, ny)), ([v], (nx, ny + 1)), ([p], (nx, ny))], active,
                     cases, "fused_assembly_pair")
    buf = torch.empty((cases, st.total), dtype=f32, device=dev)  # every output
    base = buf.data_ptr()
    ptrs[3:n] = [base + off for off in st.offsets]
    ptrs[n], ptrs[half + n] = visc.data_ptr(), _cuda.case_stride(visc, cases, (4,), f32, "visc")
    _cuda.check(_cuda.library().nf_fused_assembly_pair_batched(ptrs, st.ip, st.fp, stream),
                "fused_assembly_pair_batched")
    BATCH_LAUNCHES += 1
    return _result_of(_outputs(buf, st.groups, cases), with_bounds, variant >= 0)


class _AssemblyCases(torch.autograd.Function):
    """K8's batching rule: under ``torch.func.vmap`` every case's call goes
    into one :func:`fused_assembly_pair_batched` launch with its own
    conductance row and the active flags of ``_cuda.case_mask``; an operand
    shared by every case gets case stride 0."""

    generate_vmap_rule = False

    @staticmethod
    def forward(u, v, p, visc, static):
        dx, dy, rho, alpha, with_bounds, variant = static
        return _flat(fused_assembly_pair(u, v, p, dx=dx, dy=dy, rho=rho, mu=visc, alpha=alpha,
                                         with_bounds=with_bounds, poisson_variant=variant),
                     with_bounds, variant)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, u, v, p, visc, static):
        cases = info.batch_size
        dx, dy, rho, alpha, with_bounds, variant = static
        u, v, p, visc = (_cuda.case_first(a, d, cases)
                         for a, d in zip((u, v, p, visc), in_dims[:4]))
        out = fused_assembly_pair_batched(u, v, p, dx=dx, dy=dy, rho=rho, visc=visc,
                                          alpha=alpha, with_bounds=with_bounds,
                                          poisson_variant=variant,
                                          active=_cuda.active_cases(cases))
        flat = _flat(out, with_bounds, variant)
        return flat, (0,) * len(flat)
