"""K6: one whole outer step of SIMPLE, SIMPLEC, PISO or SIMPLER as one
kernel launch: one thread-block cluster; or the step of B cases of one
configuration as one launch of B clusters, one a case
(:func:`fused_outer_step_batched`, the lockstep loop of
``algorithms/batch.py``).

Replaces ``naviflow_tpu/ops/pallas_step.py:fused_outer_step`` /
``fused_simple_step`` (its four step bodies); the CUDA kernel is
``csrc/step.cuh`` over ``csrc/cluster.cuh`` (their headers say the order of
each step, what bounds it on the H100 and how the cluster stays in step).

Each body differs from its composed ``algorithms/<algo>.make_<algo>_step``
as the reference kernel does: the momentum solves use compensated dots and
the compensated residual, the coarse operators are rebuilt for every
pressure solve (``coarse_rebuild_every`` is ignored; the lagged carry
passes through), and each multigrid solve starts from zeros with the
whole-solve kernel's compensated stopping norms, mean-normalised unless the
Poisson variant is 'reference'.  PISO's Jacobi corrector keeps its plain
sweeps.  :func:`fused_outer_step_plain` is that step composed, the CPU path
and the kernel's oracle; :func:`fused_outer_step_batched_plain` runs it case
by case.

The batched launch gives each case its own viscosity (the one per-case
scalar of a Reynolds sweep) as the single launch's float32 ``mu dy / dx``
and ``mu dx / dy``, rounded on the host, and runs each case through the
single launch's code at its cluster size: each case's outputs are those of
:func:`fused_outer_step` on that case alone, bit for bit.

The gate's budgets are the reference's TPU VMEM budgets, kept so that the
port dispatches as the reference does; they are not H100 limits.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from . import _cuda
from .compensated import fold_norm2
from .mg import _padded_bytes, fused_mg_solve_plain, galerkin_levels_plain, supports_fused
from .poisson import poisson_coefficients, pressure_rhs
from .stencil9 import Stencil9, from_poisson

STEP_VMEM_BUDGET_BYTES = 12 * 2**20
_ALGO_VMEM_BUDGETS = {
    "simple": STEP_VMEM_BUDGET_BYTES,
    "simplec": 14 * 2**20,
    "piso": 14 * 2**20,
    "simpler": 14 * 2**20,
}
_ALGO_FINE_TEMPS = {"simple": 30, "simplec": 32, "piso": 38, "simpler": 36}

# (scalar carries in, scalar results out) per algorithm
ALGO_SCALARS = {
    "simple": (1, 4),   # p_max -> p_max', u_norm, v_norm, p_rel
    "simplec": (2, 5),  # alpha_p, prev -> alpha_p', total, u_res, v_res, p_res
    "piso": (1, 4),     # p_max -> p_max', u_norm, v_norm, p_rel
    "simpler": (1, 4),  # p_max (unused) -> p_max, u_norm, v_norm, p_rel
}

_VARIANTS = {"consistent": 0, "symmetric": 1, "reference": 2}
_ALGOS = {"simple": 0, "simplec": 1, "piso": 2, "simpler": 3}  # csrc/step.cuh Algo
_SIDES = ("top", "bottom", "left", "right")

LAUNCHES = 0  # fused_outer_step's launches (not the timed instantiation's)
BATCH_LAUNCHES = 0  # fused_outer_step_batched's launches (one for B cases)

# csrc/coop.cuh NF_SMALL_CELLS: K6 keeps the coarse levels this small in
# shared memory (csrc/cluster.cuh), the wrapper allocates none for them
SMALL_CELLS = 1024
N_IO = 12  # launch_slots: the inputs and outputs, filled in per call
_NAMES = ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")
_KW = ("dx", "dy", "rho", "mu", "bc", "cfg", "mom_cfg", "pres_cfg")

# csrc/cluster.cuh NfPhase, in order: the phases of nf_fused_outer_step_phases
PHASE_NAMES = ("bcs_assembly", "u_bicgstab", "v_bicgstab", "residual_norms", "rhs_operator",
               "rap", "mg_fine", "mg_coarse", "corrections", "final_norms")


N_TIMERS = 2 * len(PHASE_NAMES) + 1


def decode_phases(buf):
    """The phase-timer buffer of ``nf_fused_outer_step_phases`` (per phase
    the summed ns, then per phase the count, then the last stamp) as
    ``{name: (ms, count)}``."""
    vals = [int(x) for x in buf]
    n = len(PHASE_NAMES)
    if len(vals) != N_TIMERS:
        raise ValueError(f"expected {N_TIMERS} timer slots, got {len(vals)}")
    return {name: (vals[k] / 1e6, vals[n + k]) for k, name in enumerate(PHASE_NAMES)}


def step_shapes(nx: int, ny: int, pres_cfg):
    """The multigrid level shapes of the step kernel (odd/vertex)."""
    shapes = [(nx, ny)]
    while min(shapes[-1]) > pres_cfg.coarsest_grid_size:
        shapes.append(((shapes[-1][0] - 1) // 2, (shapes[-1][1] - 1) // 2))
    return shapes


def supports_fused_step(nx, ny, simple_cfg, mom_cfg, pres_cfg, dtype,
                        algo: str = "simple") -> bool:
    """Gate: power-law BiCGSTAB momentum, a multigrid V-cycle config the
    fused solve takes, an odd square grid, everything within the TPU
    budget (the reference's rule)."""
    if dtype != torch.float32 or algo not in ALGO_SCALARS:
        return False
    if (getattr(mom_cfg, "kind", "") != "bicgstab"
            or getattr(mom_cfg, "scheme", "power_law") != "power_law"):
        return False
    if getattr(pres_cfg, "kind", "") != "multigrid":
        return False
    # no in-kernel FMG bootstrap: the step's solve starts from zeros
    if getattr(pres_cfg, "cycle_type", "v") != "v":
        return False
    if algo == "piso" and getattr(simple_cfg, "corrector", "jacobi") not in ("jacobi", "exact"):
        return False
    shapes = step_shapes(nx, ny, pres_cfg)
    z = torch.zeros((1, 1), dtype=dtype)
    fake_levels = [(Stencil9(*(z,) * 9), shp, lvl == 0, None)
                   for lvl, shp in enumerate(shapes)]
    if not supports_fused(fake_levels, pres_cfg):
        return False
    total = _ALGO_FINE_TEMPS[algo] * _padded_bytes(nx, ny)
    for lvl, (snx, sny) in enumerate(shapes):
        total += ((5 if lvl == 0 else 9) + 3) * _padded_bytes(snx, sny)
    return total <= _ALGO_VMEM_BUDGETS[algo]


def _check_algo(algo, scalars):
    if algo not in ALGO_SCALARS:
        raise ValueError(f"Unknown algorithm: {algo}")
    if len(scalars) != ALGO_SCALARS[algo][0]:
        raise ValueError(f"{algo}: expected {ALGO_SCALARS[algo][0]} scalar carries, "
                         f"got {len(scalars)}")


def fused_outer_step_plain(algo, u, v, p, scalars, *, dx, dy, rho, mu, bc, cfg, mom_cfg,
                           pres_cfg):
    """The step composed (see the module docstring).  Returns ``(u', v',
    p', scalars_out, cycles, r_u, r_v, r_p)``."""
    from ..algorithms.simplec import _smooth_p_prime
    from ..core.bc import enforce_pressure_bcs
    from ..solvers.momentum import JacobiMomentumConfig, solve_u_momentum, solve_v_momentum
    from ..solvers.velocity import update_velocity

    _check_algo(algo, scalars)
    mom = dataclasses.replace(mom_cfg, backend="composed", compensated_dots=True,
                              compensated_residual=True)
    pin = cfg.poisson_variant == "reference"
    shapes = step_shapes(*p.shape, pres_cfg)

    def scalar(s):
        return torch.as_tensor(s, dtype=p.dtype, device=p.device)

    def mom_pair(uu, vv, pp, alpha, mcfg):
        kw = dict(dx=dx, dy=dy, rho=rho, mu=mu, alpha=alpha, bc=bc, cfg=mcfg)
        u_star, d_u, r_u, u_norm = solve_u_momentum(uu, vv, pp, **kw)
        v_star, d_v, r_v, v_norm = solve_v_momentum(uu, vv, pp, **kw)
        return u_star, v_star, d_u, d_v, r_u, r_v, u_norm, v_norm

    def psolve(u_star, v_star, d_u, d_v):
        """RHS, fine operator, every coarse operator, the whole multigrid
        solve from zeros; returns (p', r_p, cycles)."""
        b = pressure_rhs(u_star, v_star, dx=dx, dy=dy, rho=rho, pin=pin)
        fine = from_poisson(poisson_coefficients(d_u, d_v, dx=dx, dy=dy, rho=rho,
                                                 variant=cfg.poisson_variant))
        levels = [(fine, shapes[0], True, None)] + [
            (st, shp, False, None)
            for st, shp in zip(galerkin_levels_plain(fine, shapes, True), shapes[1:])]
        p_prime, r_p, cycles, _ = fused_mg_solve_plain(torch.zeros_like(p), b, levels,
                                                       pres_cfg, mean_normalize=not pin)
        return p_prime, r_p, cycles

    def p_rel_of(r_p, p_max):
        p_l2 = torch.sqrt(fold_norm2(r_p[1:-1, 1:-1]))
        p_max_new = torch.maximum(scalar(p_max), p_l2)
        return torch.where(p_max_new > 0, p_l2 / p_max_new, torch.ones_like(p_l2)), p_max_new

    def bcs(pp):
        return enforce_pressure_bcs(pp, bc) if cfg.overwrite_boundary_pressure else pp

    if algo == "simple":
        (p_max,) = scalars
        u_star, v_star, d_u, d_v, r_u, r_v, u_norm, v_norm = mom_pair(u, v, p, cfg.alpha_u, mom)
        p_prime, r_p, cycles = psolve(u_star, v_star, d_u, d_v)
        p_new = bcs(p + cfg.alpha_p * p_prime)
        u_new, v_new = update_velocity(u_star, v_star, p_prime, d_u, d_v, bc)
        p_rel, p_max_new = p_rel_of(r_p, p_max)
        sc_out = (p_max_new, u_norm, v_norm, p_rel)
    elif algo == "simplec":
        alpha_p, prev_res = scalar(scalars[0]), scalar(scalars[1])
        u_star, v_star, d_u, d_v, r_u, r_v, _, _ = mom_pair(u, v, p, cfg.alpha_u, mom)
        d_u_c, d_v_c = d_u / cfg.alpha_u, d_v / cfg.alpha_u
        p_prime, r_p, cycles = psolve(u_star, v_star, d_u_c, d_v_c)
        if cfg.smooth_p_prime:
            p_prime = _smooth_p_prime(p_prime)
        p_new = bcs(p + alpha_p * p_prime)
        u_new, v_new = update_velocity(u_star, v_star, p_prime, d_u_c, d_v_c, bc)
        u_res = torch.max(torch.abs(u_new - u))
        v_res = torch.max(torch.abs(v_new - v))
        p_res = torch.max(torch.abs(p_new - p))
        total = torch.maximum(u_res, v_res)
        if cfg.dynamic_alpha_p:
            alpha_p = torch.where(total > prev_res, alpha_p * 0.95, alpha_p)
        sc_out = (alpha_p, total, u_res, v_res, p_res)
    elif algo == "piso":
        (p_max,) = scalars
        corr = (mom if cfg.corrector == "exact"
                else JacobiMomentumConfig(n_sweeps=cfg.corrector_sweeps,
                                          compensated_residual=True))
        u_star, v_star, d_u, d_v, r_u, r_v, u_norm, v_norm = mom_pair(u, v, p, cfg.alpha_u, mom)
        cycles = 0
        uu, vv, pp = u, v, p
        for k in range(cfg.n_corrections):
            p_prime, r_p, cyc = psolve(u_star, v_star, d_u, d_v)
            cycles = cycles + cyc
            pp = bcs(pp + cfg.alpha_p * p_prime)
            uu, vv = update_velocity(u_star, v_star, p_prime, d_u, d_v, bc)
            u_star, v_star = uu, vv
            if k < cfg.n_corrections - 1:
                u_star, v_star, d_u, d_v, _, _, _, _ = mom_pair(uu, vv, pp, 1.0, corr)
        u_new, v_new, p_new = uu, vv, pp
        p_rel, p_max_new = p_rel_of(r_p, p_max)
        sc_out = (p_max_new, u_norm, v_norm, p_rel)
    else:  # simpler
        (p_max,) = scalars
        u_star, v_star, d_u, d_v, r_u, r_v, u_norm, v_norm = mom_pair(u, v, p, cfg.alpha_u, mom)
        p_bar, _, cyc1 = psolve(u_star, v_star, d_u, d_v)
        pp = bcs(p + p_bar)
        u_star, v_star, d_u, d_v, _, _, _, _ = mom_pair(u, v, pp, cfg.alpha_u, mom)
        p_prime, r_p, cyc2 = psolve(u_star, v_star, d_u, d_v)
        cycles = cyc1 + cyc2
        p_new = bcs(pp + cfg.alpha_p * p_prime)
        u_new, v_new = update_velocity(u_star, v_star, p_prime, d_u, d_v, bc)
        p_rel = torch.sqrt(fold_norm2(p_new - p)) / (math.sqrt(p.numel()) + 1e-30)
        sc_out = (scalar(p_max), u_norm, v_norm, p_rel)
    return u_new, v_new, p_new, sc_out, cycles, r_u, r_v, r_p


def launch_slots(algo, nx, ny, shapes, timers: bool = False):
    """The pointer slots of ``nf_fused_outer_step`` (``_phases`` with
    ``timers``) in the order ``csrc/step.cuh``'s ``launch_step`` reads them:
    ``(name, shape, dtype)`` each.  The first :data:`N_IO` are the inputs
    and outputs, the rest scratch; a coarse level of at most
    :data:`SMALL_CELLS` cells has no slots (it lives in shared memory)."""
    n_in, n_out = ALGO_SCALARS[algo]
    f32 = torch.float32
    us, vs, ps = (nx + 1, ny), (nx, ny + 1), (nx, ny)
    nk = max((nx + 1) * ny, nx * (ny + 1))
    slots = [("u", us, f32), ("v", vs, f32), ("p", ps, f32), ("scalars_in", (n_in,), f32),
             ("u_out", us, f32), ("v_out", vs, f32), ("p_out", ps, f32),
             ("r_u", us, f32), ("r_v", vs, f32), ("r_p", ps, f32),
             ("scalars_out", (n_out,), f32), ("cycles", (1,), torch.int32),
             ("ub", us, f32), ("vb", vs, f32)]
    slots += [(f"cu{k}", us, f32) for k in range(8)] + [(f"cv{k}", vs, f32) for k in range(8)]
    slots += [("u_star", us, f32), ("v_star", vs, f32), ("d_u", us, f32), ("d_v", vs, f32),
              ("krylov", (6 * nk,), f32), ("p_before_bcs", ps, f32), ("p_prime_smoothed", ps, f32)]
    slots += [(f"fine_{k}", ps, f32) for k in _NAMES[:5]] + [("b", ps, f32), ("p_prime", ps, f32)]
    for lvl, (ni, nj) in enumerate(shapes[1:], 1):
        if ni * nj > SMALL_CELLS:
            slots += [(f"level{lvl}_{k}", (ni, nj), f32) for k in _NAMES + ("x", "rhs")]
    if timers:
        slots.append(("timers", (N_TIMERS,), torch.int64))
    return slots


def batched_launch_slots(algo, nx, ny, shapes):
    """The slots of ``nf_fused_outer_step_batched``, per case: those of
    :func:`launch_slots`, then what a frozen case returns beside its inputs
    (its held scalar results, residual fields and cycles), its active flag
    and its ``(De, Dn)``.  The C entry reads them as case 0's addresses,
    then every slot's case stride in bytes in the same order."""
    n_out = ALGO_SCALARS[algo][1]
    f32 = torch.float32
    us, vs, ps = (nx + 1, ny), (nx, ny + 1), (nx, ny)
    return launch_slots(algo, nx, ny, shapes) + [
        ("scalars_held", (n_out,), f32), ("r_u_held", us, f32), ("r_v_held", vs, f32),
        ("r_p_held", ps, f32), ("cycles_held", (), torch.int32), ("active", (), torch.bool),
        ("visc", (2,), f32)]


def launch_params(algo, nx, ny, shapes, *, dx, dy, rho, mu, bc, cfg, mom_cfg, pres_cfg):
    """``(ip, fp)``, the integer and float parameters of the C entry in
    ``csrc/step.cuh``'s order."""
    sides = [bc.side(name) for name in _SIDES]
    ip = [_ALGOS[algo], nx, ny, len(shapes), pres_cfg.pre_smoothing, pres_cfg.post_smoothing,
          pres_cfg.coarsest_sweeps, pres_cfg.max_cycles, pres_cfg.check_every,
          mom_cfg.max_iterations, int(cfg.poisson_variant == "reference"),
          _VARIANTS[cfg.poisson_variant], int(cfg.overwrite_boundary_pressure),
          getattr(cfg, "n_corrections", 0), int(getattr(cfg, "corrector", "") == "exact"),
          getattr(cfg, "corrector_sweeps", 0), int(getattr(cfg, "smooth_p_prime", False)),
          int(getattr(cfg, "dynamic_alpha_p", False))]
    ip += [int(s.kind.value == "velocity") for s in sides]
    ip += [n for shp in shapes for n in shp]
    fp = [0.5 * rho * dy, 0.5 * rho * dx, mu * dy / dx, mu * dx / dy, dx, dy,
          cfg.alpha_u, 1.0 - cfg.alpha_u, rho, cfg.alpha_p, mom_cfg.tolerance,
          pres_cfg.tolerance, pres_cfg.omega]
    fp += [s.u for s in sides] + [s.v for s in sides]
    return ip, fp


def fused_outer_step(algo, u, v, p, scalars, *, dx, dy, rho, mu, bc, cfg, mom_cfg, pres_cfg):
    """One outer iteration of ``algo`` as one kernel launch (always-fresh
    coarse operators).  ``scalars`` is the algorithm's scalar carry (see
    ``ALGO_SCALARS``).  Returns ``(u', v', p', scalars_out, cycles, r_u,
    r_v, r_p)`` with the scalars as 0-d tensors."""
    global LAUNCHES
    _check_algo(algo, scalars)
    if not u.is_cuda:
        return fused_outer_step_plain(algo, u, v, p, scalars, dx=dx, dy=dy, rho=rho, mu=mu,
                                      bc=bc, cfg=cfg, mom_cfg=mom_cfg, pres_cfg=pres_cfg)
    out = _launch(algo, u, v, p, scalars, None, dx=dx, dy=dy, rho=rho, mu=mu, bc=bc, cfg=cfg,
                  mom_cfg=mom_cfg, pres_cfg=pres_cfg)
    LAUNCHES += 1
    return out


def _check_batch(algo, u, scalars, active, mu, held):
    if algo not in ALGO_SCALARS:
        raise ValueError(f"Unknown algorithm: {algo}")
    n_in, n_out = ALGO_SCALARS[algo]
    cases = u.shape[0]
    if tuple(scalars.shape) != (cases, n_in):
        raise ValueError(f"{algo}: expected scalar carries of shape ({cases}, {n_in}), "
                         f"got {tuple(scalars.shape)}")
    if len(mu) != cases or tuple(active.shape) != (cases,) or active.dtype != torch.bool:
        raise ValueError(f"expected {cases} viscosities and a ({cases},) bool active mask")
    if held is not None and len(held) != 5:
        raise ValueError("held: (scalars_out, cycles, r_u, r_v, r_p)")


def fused_outer_step_batched_plain(algo, u, v, p, scalars, active, *, mu, dx, dy, rho, bc, cfg,
                                   mom_cfg, pres_cfg, held=None):
    """:func:`fused_outer_step_batched` case by case through
    :func:`fused_outer_step_plain` (the CPU path and the batched kernel's
    oracle)."""
    _check_batch(algo, u, scalars, active, mu, held)
    n_in, n_out = ALGO_SCALARS[algo]
    kw = dict(dx=dx, dy=dy, rho=rho, bc=bc, cfg=cfg, mom_cfg=mom_cfg, pres_cfg=pres_cfg)
    outs = []
    for b, on in enumerate(active.tolist()):
        if on:
            u2, v2, p2, sc, cyc, r_u, r_v, r_p = fused_outer_step_plain(
                algo, u[b], v[b], p[b], tuple(scalars[b]), mu=mu[b], **kw)
            sc = torch.stack([torch.as_tensor(x, dtype=p.dtype, device=p.device).reshape(())
                              for x in sc])
        else:  # frozen: the inputs, and the held results (or zeros)
            h_sc, cyc, r_u, r_v, r_p = ((x[b] for x in held) if held is not None else
                                        (torch.zeros(n_out, dtype=p.dtype, device=p.device), 0,
                                         torch.zeros_like(u[b]), torch.zeros_like(v[b]),
                                         torch.zeros_like(p[b])))
            u2, v2, p2 = u[b], v[b], p[b]
            sc = torch.cat([scalars[b].to(p.dtype), h_sc[n_in:].to(p.dtype)])
        outs.append((u2, v2, p2, sc, torch.as_tensor(cyc, dtype=torch.int32, device=p.device),
                     r_u, r_v, r_p))
    return tuple(torch.stack(list(parts)) for parts in zip(*outs))


def fused_outer_step_batched(algo, u, v, p, scalars, active, *, mu, dx, dy, rho, bc, cfg,
                             mom_cfg, pres_cfg, held=None):
    """The step of B cases of one configuration as one kernel launch, case b
    with viscosity ``mu[b]``: ``u`` (B, nx+1, ny), ``v`` (B, nx, ny+1), ``p``
    (B, nx, ny), ``scalars`` (B, n_in) (see ``ALGO_SCALARS``), ``active``
    a (B,) bool tensor on the state's device.  Returns
    :func:`fused_outer_step`'s outputs with a leading case axis: ``(u', v',
    p', scalars_out (B, n_out), cycles (B,) int32, r_u, r_v, r_p)``.  An
    active case's are :func:`fused_outer_step`'s on that case alone, bit
    for bit.  A frozen case (``active`` false) gets its inputs back: its
    state, its scalar carries in the first n_in results, and from ``held``
    = ``(scalars_out, cycles, r_u, r_v, r_p)`` (a previous step's outputs)
    its other results (zeros without ``held``).  Each case's slice of every
    argument must be contiguous."""
    global BATCH_LAUNCHES
    _check_batch(algo, u, scalars, active, mu, held)
    kw = dict(dx=dx, dy=dy, rho=rho, bc=bc, cfg=cfg, mom_cfg=mom_cfg, pres_cfg=pres_cfg)
    if not u.is_cuda:
        return fused_outer_step_batched_plain(algo, u, v, p, scalars, active, mu=mu,
                                              held=held, **kw)
    out = _launch_batched(algo, u, v, p, scalars, active, held, tuple(mu), kw)
    BATCH_LAUNCHES += 1
    return out


def fused_outer_step_phases(algo, u, v, p, scalars, *, dx, dy, rho, mu, bc, cfg, mom_cfg,
                            pres_cfg):
    """:func:`fused_outer_step` through the instantiation with phase timers
    (``nf_fused_outer_step_phases``), a measurement aid: CUDA tensors only,
    not counted in ``LAUNCHES``.  Returns the step's outputs and
    :func:`decode_phases` of its timers (after a synchronise)."""
    _check_algo(algo, scalars)
    timers = torch.zeros(N_TIMERS, dtype=torch.int64, device=u.device)
    out = _launch(algo, u, v, p, scalars, timers, dx=dx, dy=dy, rho=rho, mu=mu, bc=bc, cfg=cfg,
                  mom_cfg=mom_cfg, pres_cfg=pres_cfg)
    return out, decode_phases(timers.cpu())


def cluster_size(algo: str, device=None) -> int:
    """The thread-block cluster size K6's ``algo`` body launches with on
    ``device`` (16 where one such cluster fits on the card, else 8)."""
    with torch.cuda.device(device):
        size = ctypes.c_int(0)
        _cuda.check(_cuda.library().nf_step_cluster_size(_ALGOS[algo], ctypes.byref(size)),
                    "step_cluster_size")
    return size.value


def max_active_clusters(algo: str, size: int, device=None) -> int:
    """How many clusters of ``size`` CTAs of K6's batched ``algo`` body the
    card on ``device`` holds at once: a batch of more cases runs in
    waves."""
    with torch.cuda.device(device):
        count = ctypes.c_int(0)
        _cuda.check(_cuda.library().nf_step_max_clusters(_ALGOS[algo], size,
                                                         ctypes.byref(count)),
                    "step_max_clusters")
    return count.value


# Launch state reused across calls (the wrapper's host time per call is part
# of every 63^2 step): per (device, stream, algo, shapes, timers) the scratch
# tensors and the pointer array with their slots filled; per configuration
# the level shapes and the parameter arrays.  The inputs and the outputs
# (u', v', p', r_*, scalars, cycles: one fresh buffer a call, which the
# caller keeps across steps) are filled in per call.
_SCRATCH = {}
_PARAMS = {}
_CACHE_MAX = 32


def _params(algo, nx, ny, kw):
    key = (algo, nx, ny) + tuple(kw[k] for k in _KW)
    got = _PARAMS.get(key)
    if got is None:
        if kw["cfg"].poisson_variant not in _VARIANTS:
            raise ValueError(f"Unknown poisson operator variant: {kw['cfg'].poisson_variant}")
        if algo == "piso" and kw["cfg"].corrector not in ("jacobi", "exact"):
            raise ValueError(f"Unknown PISO corrector: {kw['cfg'].corrector}")
        shapes = step_shapes(nx, ny, kw["pres_cfg"])
        ip, fp = launch_params(algo, nx, ny, shapes, **kw)
        if len(_PARAMS) >= _CACHE_MAX:
            _PARAMS.clear()
        got = _PARAMS[key] = (shapes, (ctypes.c_int * len(ip))(*ip),
                              (ctypes.c_float * len(fp))(*fp))
    return got


def _scratch(algo, nx, ny, shapes, timed, dev, stream, cases=None):
    """The scratch tensors, the pointer array with their slots filled, the
    output shapes and sizes.  ``cases``: the batched entry's, each scratch
    slot (cases, *shape), the array twice as long (the strides after the
    addresses, the scratch ones filled)."""
    key = (dev, stream, algo, nx, ny, tuple(shapes), timed, cases)
    got = _SCRATCH.get(key)
    if got is None:
        if cases is None:
            slots = launch_slots(algo, nx, ny, shapes, timed)
            lead, tail = (), timed
        else:
            slots = batched_launch_slots(algo, nx, ny, shapes)
            lead, tail = (cases,), 7
        keep = [torch.empty(lead + shape, dtype=dtype, device=dev)
                for _, shape, dtype in slots[N_IO:len(slots) - tail]]
        addrs = [0] * N_IO + [t.data_ptr() for t in keep] + [0] * tail
        if cases is not None:
            addrs += [0] * N_IO + [4 * math.prod(t.shape[1:]) for t in keep] + [0] * tail
        ptrs = (ctypes.c_longlong * len(addrs))(*addrs)
        outs = [(shape, dtype) for _, shape, dtype in slots[4:N_IO]]
        if len(_SCRATCH) >= _CACHE_MAX:
            _SCRATCH.clear()
        got = _SCRATCH[key] = (keep, ptrs, outs, [math.prod(s) for s, _ in outs])
    return got


def _batch_params(algo, nx, ny, kw, mus, dev):
    """:func:`_params` of the first case with the case count appended to
    the integer parameters, and the cases' ``(De, Dn) = (mu dy / dx, mu dx /
    dy)`` on ``dev``: the float64 products rounded to float32, as
    :func:`launch_params` gives them to the single launch."""
    key = ("batched", algo, nx, ny, dev, mus) + tuple(kw[k] for k in _KW if k != "mu")
    got = _PARAMS.get(key)
    if got is None:
        shapes, c_ip, c_fp = _params(algo, nx, ny, dict(kw, mu=mus[0]))
        ip = list(c_ip) + [len(mus)]
        dx, dy = kw["dx"], kw["dy"]
        visc = torch.tensor([[mu * dy / dx, mu * dx / dy] for mu in mus],
                            dtype=torch.float32).to(dev)
        got = _PARAMS[key] = (shapes, (ctypes.c_int * len(ip))(*ip), c_fp, visc)
    return got


def _scalars_ptr(scalars, dev):
    """The device address of the scalar carries, and the tensor holding
    them: the carries themselves where they are consecutive float32
    elements on ``dev`` (the last step's results), else a fresh stack."""
    first = scalars[0]
    if all(torch.is_tensor(s) and s.device == dev and s.dtype == torch.float32
           and s.numel() == 1 for s in scalars):
        addr = first.data_ptr()
        if all(s.data_ptr() == addr + 4 * k for k, s in enumerate(scalars)):
            return addr, first
    held = torch.stack([torch.as_tensor(s, dtype=torch.float32, device=dev).reshape(())
                        for s in scalars])
    return held.data_ptr(), held


def _launch(algo, u, v, p, scalars, timers, **kw):
    nx, ny = p.shape
    _cuda.require(u, (nx + 1, ny), "u")
    _cuda.require(v, (nx, ny + 1), "v")
    _cuda.require(p, (nx, ny), "p")
    dev = u.device
    stream = _cuda.stream_of(u)
    shapes, c_ip, c_fp = _params(algo, nx, ny, kw)
    _, ptrs, outs, sizes = _scratch(algo, nx, ny, shapes, timers is not None, dev, stream)
    sc_addr, sc_held = _scalars_ptr(scalars, dev)  # held until the launch is enqueued
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    ptrs[0], ptrs[1], ptrs[2], ptrs[3] = u.data_ptr(), v.data_ptr(), p.data_ptr(), sc_addr
    addr = flat.data_ptr()
    for k, n in enumerate(sizes):
        ptrs[4 + k] = addr
        addr += 4 * n
    entry = "nf_fused_outer_step"
    if timers is not None:
        ptrs[len(ptrs) - 1] = timers.data_ptr()
        entry = "nf_fused_outer_step_phases"
    _cuda.check(getattr(_cuda.library(), entry)(ptrs, c_ip, c_fp, stream), entry)
    parts = flat.split(sizes)
    u2, v2, p2, r_u, r_v, r_p = (t.view(shape) for t, (shape, _) in zip(parts[:6], outs))
    cyc = parts[7].view(torch.int32)
    return u2, v2, p2, parts[6].unbind(0), cyc[0], r_u, r_v, r_p


def _launch_batched(algo, u, v, p, scalars, active, held, mus, kw):
    cases, nx, ny = p.shape
    n_in, n_out = ALGO_SCALARS[algo]
    dev = u.device
    f32 = torch.float32
    us, vs, ps = (nx + 1, ny), (nx, ny + 1), (nx, ny)
    stream = _cuda.stream_of(u)
    shapes, c_ip, c_fp, visc = _batch_params(algo, nx, ny, kw, mus, dev)
    _, ptrs, outs, sizes = _scratch(algo, nx, ny, shapes, False, dev, stream, cases)
    half = len(ptrs) // 2
    ins = [(u, us, f32, "u"), (v, vs, f32, "v"), (p, ps, f32, "p"),
           (scalars, (n_in,), f32, "scalars")]
    for k, (x, shape, dtype, name) in enumerate(ins):
        ptrs[half + k] = _cuda.case_stride(x, cases, shape, dtype, name)
        ptrs[k] = x.data_ptr()
    extras = [(active, (), torch.bool, "active"), (visc, (2,), f32, "visc")]
    if held is not None:
        h_sc, h_cyc, h_ru, h_rv, h_rp = held
        extras = [(h_sc, (n_out,), f32, "held scalars"), (h_ru, us, f32, "held r_u"),
                  (h_rv, vs, f32, "held r_v"), (h_rp, ps, f32, "held r_p"),
                  (h_cyc, (), torch.int32, "held cycles")] + extras
    else:
        for k in range(half - 7, half - 2):
            ptrs[k] = ptrs[half + k] = 0
    for k, (x, shape, dtype, name) in enumerate(extras, half - len(extras)):
        ptrs[half + k] = _cuda.case_stride(x, cases, shape, dtype, name)
        ptrs[k] = x.data_ptr()
    # the outputs: one buffer, each output (cases, *shape) contiguous in it
    flat = torch.empty(cases * sum(sizes), dtype=f32, device=dev)
    addr = flat.data_ptr()
    for k, n in enumerate(sizes):
        ptrs[4 + k], ptrs[half + 4 + k] = addr, 4 * n
        addr += 4 * cases * n
    entry = "nf_fused_outer_step_batched"
    _cuda.check(getattr(_cuda.library(), entry)(ptrs, c_ip, c_fp, stream), entry)
    parts = flat.split([cases * n for n in sizes])
    u2, v2, p2, r_u, r_v, r_p = (t.view((cases,) + shape) for t, (shape, _) in
                                 zip(parts[:6], outs))
    return u2, v2, p2, parts[6].view(cases, n_out), parts[7].view(torch.int32), r_u, r_v, r_p


def fused_simple_step(u, v, p, p_max_l2, *, dx, dy, rho, mu, bc, simple_cfg, mom_cfg,
                      pres_cfg):
    """One SIMPLE outer iteration as one kernel launch.  Returns ``(u', v',
    p', p_max', u_norm, v_norm, p_rel, cycles, r_u, r_v, r_p)``, the step
    contract of ``make_simple_step``."""
    u2, v2, p2, (p_max2, u_norm, v_norm, p_rel), cycles, r_u, r_v, r_p = fused_outer_step(
        "simple", u, v, p, (p_max_l2,), dx=dx, dy=dy, rho=rho, mu=mu, bc=bc,
        cfg=simple_cfg, mom_cfg=mom_cfg, pres_cfg=pres_cfg)
    return u2, v2, p2, p_max2, u_norm, v_norm, p_rel, cycles, r_u, r_v, r_p
