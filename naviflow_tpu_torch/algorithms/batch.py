"""Case batching: one cavity grid solved for a list of Reynolds numbers
(port of ``naviflow_tpu/algorithms/batch.py``).

The JAX package runs the cases as one ``jax.vmap`` over its
``lax.while_loop``: one program, all cases in lockstep, each case's carry
masked by its own predicate, so each case freezes at its own iteration
count and device time is set by the slowest case.  The port runs that
loop written out (``base.run_outer_loop_batched``): a leading case axis on
the state, the residuals and the histories, and one host read a step of
whether any case is still active.  A lockstep step takes one of three
branches:

* where the whole-step kernel's gate admits the configuration
  (``simple.fused_step_ok``), one launch of K6's batched entry
  (``ops/step.fused_outer_step_batched``: one thread-block cluster a case,
  frozen cases leaving at once);
* else, where :func:`vmap_step_ok` admits it, ``torch.func.vmap`` of the
  single step over (u, v, p, the carry, each case's viscous
  conductances), the port of ``jax.vmap(one)``: the composed operators
  run once for every case, and every kernel of the step launches once
  for every case through its batching rule, frozen cases' blocks leaving
  at once; the frozen cases then get back what they were given.  Its odd
  arm (an odd square grid, multigrid pressure whose solve K5 and whose
  hierarchy K4 take, BiCGSTAB momentum through K7's gate or fixed-sweep
  Jacobi: the 63^2 FMG headline step) runs K7, K5 and K4
  (``ops/krylov.py``, ``ops/mg.py``); its even arm (an even square grid,
  a fixed number of multigrid V-cycles that K5 takes whole, or K2 strips
  and a K3 tail take below the finest level, which is K2's or, in the
  colour-plane layout, K10's; Chebyshev momentum through K1's lagged
  carry, or through the one-pass assembly K8 and the Chebyshev strips K9
  where their gates open and composed where they do not; fixed-sweep
  Jacobi or red-black GS momentum through K8: ``bench.py``'s large-grid
  SIMPLE step, SIMPLEC, PISO and SIMPLER at 2048^2, SIMPLE with Jacobi or
  RBGS momentum from 384^2, and ``large_grid_3``'s plane layout at
  4096^2) runs K1, K8, K9, K10a, K10b, K2a, K2b and K3
  (``ops/asmcheby.py``, ``ops/assembly.py``, ``ops/cheby.py``,
  ``ops/plane_strip.py``, ``ops/strip.py``, ``ops/mg.py``) or K5.  Both
  arms take BiCGSTAB momentum and a pressure tolerance: the loops that
  read the host (``solvers/momentum.py``'s ``_bicgstab_masked`` and
  ``_bicgstab_pair_masked``, ``solvers/multigrid.py``'s tolerance loop)
  run through ``ops/while_loop.py``, whose batching rule iterates every
  case in one masked loop with one host read an iteration, and K7 takes
  each field in one launch for every case in its band form (one cluster
  a case) or its grid form (one cooperative grid): the command line's
  default ``sweep --vmap`` on even grids, ``bench.py``'s sequenced
  configuration at any of its levels, and the FMG headline at 255^2;
* else every active case's own step, one after another (composed, or with
  its own kernels): the CPU path (where the kernel gates are closed), and
  every configuration the other two refuse: GMRES and IDR(s) momentum,
  the Krylov and MGCG pressure solvers (the same loop primitive would
  serve them) and the rest of the momentum and pressure zoos; W and FMG
  cycles on even grids; the compensated residual and dots; the 9-point
  schemes; odd grids above 255^2 under the command line's default (K5
  cannot take their whole solve, and the odd arm needs it).

Each case's result is its single solve's: bit for bit in the K6 and per-case
branches, and in the vmapped one wherever the batched operators round as
the single ones do (the batched ``torch.mean`` of the pressure correction
and ``torch.linalg.vector_norm`` of the residuals do not, on the card).  Viscosity is the one per-case scalar (cavity Re = rho U
L / mu with U = L = 1).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..core.bc import BoundaryConditions
from ..core.fluid import FluidProperties
from ..core.mesh import StructuredMesh
from ..core.state import FlowState, initialize_state
from ..ops import _cuda
from ..ops.assembly import supports_fused_assembly
from ..ops.krylov import supports_fused_bicgstab
from ..ops.mg import supports_fused_layout, supports_fused_rap
from ..ops.plane_strip import supports_plane_strip
from ..ops.powerlaw import case_conductances
from ..ops.step import ALGO_SCALARS, fused_outer_step_batched
from ..ops.strip import supports_strip
from ..ops.transfer import coarse_size
from ..ops.while_loop import flatten as _flatten
from ..solvers.momentum import lagged_rho_enabled
from .base import SolveDiagnostics, StepInfo, case_info, run_outer_loop_batched
from .lagged import make_lagged_mg, uses_lagged_mg
from .piso import make_piso_step
from .simple import (family_parts, fused_step_ok, lagged_extra0, make_simple_step, rho_extra0,
                     simple_parts, zero_carry)
from .simplec import make_simplec_step, simplec_carry0
from .simpler import make_simpler_step

# algorithm -> (its step factory, cfg -> its initial scalar carry); SIMPLE
# builds its own parts (the lagged Gershgorin carry)
_FAMILY = {
    "simple": (None, lambda cfg: zero_carry),
    "simplec": (make_simplec_step, simplec_carry0),
    "simpler": (make_simpler_step, lambda cfg: zero_carry),
    "piso": (make_piso_step, lambda cfg: zero_carry),
}


def _per_case(steps):
    """The lockstep step of cases that each take their own step function
    ``steps[b](u, v, p, extra) -> (u, v, p, extra, StepInfo)``: the active
    cases step, the frozen ones hand back what they were given; ``extra``
    is the list of the cases' carries."""

    def step(u, v, p, extra, active, info):
        outs = [steps[b](u[b], v[b], p[b], extra[b]) if on
                else (u[b], v[b], p[b], extra[b], case_info(info, b))
                for b, on in enumerate(active.tolist())]
        us, vs, ps, extras, infos = zip(*outs)
        dt, dev = u.dtype, u.device

        def stack(xs, dtype=None):
            return torch.stack([torch.as_tensor(x, dtype=dtype, device=dev) for x in xs])

        un, vn, pn, inner, ru, rv, rp = zip(*infos)
        return (torch.stack(us), torch.stack(vs), torch.stack(ps), list(extras),
                StepInfo(stack(un, dt), stack(vn, dt), stack(pn, dt), stack(inner, torch.int32),
                         stack(ru), stack(rv), stack(rp)))

    return step


def _fused_step(algorithm, mus, kw):
    """The lockstep step as one launch of K6's batched entry; ``extra`` is
    the last step's scalar results (B, n_out), whose first n_in are the
    carries, and the lagged carry, which K6 passes through."""
    n_in = ALGO_SCALARS[algorithm][0]

    def step(u, v, p, extra, active, info):
        sc, lag = extra
        u2, v2, p2, sc2, cycles, r_u, r_v, r_p = fused_outer_step_batched(
            algorithm, u, v, p, sc[:, :n_in], active, mu=mus,
            held=(sc, info.inner_iterations, info.r_u, info.r_v, info.r_p), **kw)
        info2 = StepInfo(u_norm=sc2[:, n_in], v_norm=sc2[:, n_in + 1], p_norm=sc2[:, n_in + 2],
                         inner_iterations=cycles, r_u=r_u, r_v=r_v, r_p=r_p)
        return u2, v2, p2, (sc2, lag), info2

    return step


def vmap_step_ok(p, cfg, mom_cfg, pres_cfg, algorithm: str) -> bool:
    """The vmapped branch's gate, for the state's ``p`` (every case's
    shape): outside K6's gate, every kernel the single step would launch
    has a batching rule and every composed part runs under
    ``torch.func.vmap`` without a host read.  Two arms, by grid parity:
    :func:`_odd_step_ok` (K7, K5, K4: the FMG headline) and
    :func:`_even_step_ok` (K1, K8, K9, K10, K2, K3 or K5: ``bench.py``'s
    large-grid SIMPLE, SIMPLEC, PISO and SIMPLER, the plane layout)."""
    if not _cuda.kernel_device(p) or fused_step_ok(p, cfg, mom_cfg, pres_cfg, algorithm):
        return False
    nx, ny = p.shape[-2:]
    if nx != ny or getattr(pres_cfg, "kind", "") != "multigrid" or pres_cfg.backend == "composed":
        return False
    scheme = getattr(mom_cfg, "scheme", "power_law")
    if scheme != "power_law":
        return False
    if nx % 2:
        return _odd_step_ok(p, mom_cfg, pres_cfg)
    return _even_step_ok(p, cfg, mom_cfg, pres_cfg, algorithm)


def _odd_step_ok(p, mom_cfg, pres_cfg) -> bool:
    """An odd square grid: multigrid pressure (Galerkin V or FMG cycles)
    whose whole solve K5 takes and whose hierarchy K4 builds from the fine
    level; BiCGSTAB momentum that K7 takes for both fields (its band form or,
    past the band's shared memory, its grid form: both batched), or
    fixed-sweep Jacobi, without the one-pass assembly (K8)."""
    nx, ny = p.shape[-2:]
    if not supports_fused_rap(nx, ny, pres_cfg, p.dtype):
        return False
    layout = [((nx, ny), True)]
    while layout[-1][0][0] > pres_cfg.coarsest_grid_size:
        n = coarse_size(layout[-1][0][0])
        layout.append(((n, n), False))
    if not supports_fused_layout(layout, pres_cfg):  # K5 (its dtype: K4's gate)
        return False
    if supports_fused_assembly(nx, ny, "power_law", p.dtype, getattr(mom_cfg, "backend", "auto"),
                               p.device):
        return False
    if mom_cfg.kind == "jacobi":
        return True
    return (mom_cfg.kind == "bicgstab" and getattr(mom_cfg, "backend", "auto") != "composed"
            and supports_fused_bicgstab((nx + 1, ny), p.dtype)
            and supports_fused_bicgstab((nx, ny + 1), p.dtype))


def _even_layout(n: int, pres_cfg):
    """The ``((ni, nj), five_point)`` of each level of the Galerkin hierarchy
    of an even ``n``^2 grid (``multigrid.build_levels``' shapes), finest
    first."""
    layout = [((n, n), True)]
    while layout[-1][0][0] > pres_cfg.coarsest_grid_size:
        m = layout[-1][0][0]
        m = m // 2 if m % 2 == 0 else coarse_size(m)
        layout.append(((m, m), False))
    return layout


def _even_pressure_ok(n: int, pres_cfg, dtype) -> bool:
    """``multigrid_solve``'s kernel path on an even ``n``^2 hierarchy of
    V-cycles: the whole solve in K5 (which keeps each case's cycles and
    ``rel`` where a tolerance is set), or each V-cycle (``_cycle0``) as a K2
    pair a level above the first tail K3 takes, a fixed number of them or
    until the tolerance, whose loop runs through ``ops/while_loop.py``; in
    the colour-plane layout the finest level K10's (its planes n x n / 2)
    and the levels below it K2 pairs above a K3 tail, or one K3."""
    if (pres_cfg.cycle_type != "v"
            or pres_cfg.coarsening != "galerkin" or pres_cfg.smoother != "gs"):
        return False
    layout = _even_layout(n, pres_cfg)
    if supports_fused_layout(layout, pres_cfg):  # K5
        return dtype == torch.float32
    first = 1
    if getattr(pres_cfg, "fine_layout", "auto") == "plane":
        if len(layout) < 2 or not supports_plane_strip(n, n // 2, pres_cfg, dtype):
            return False
        layout, first = layout[1:], 0
    k = next((k for k in range(first, len(layout))
              if supports_fused_layout(layout[k:], pres_cfg)), None)
    return k is not None and all(supports_strip(*shp, five, pres_cfg, dtype)
                                 for shp, five in layout[:k])


def _even_step_ok(p, cfg, mom_cfg, pres_cfg, algorithm) -> bool:
    """An even square grid: :func:`_even_pressure_ok`; Chebyshev momentum
    (K1 through SIMPLE's lagged carry; else K8 and K9 where their gates
    open, composed where they do not), fixed-sweep Jacobi or red-black GS
    momentum whose coefficients the one-pass assembly (K8) takes, or
    BiCGSTAB momentum as the single step dispatches it (K7 per field where
    its gate opens, band or grid form; else the coefficients from K8 where
    its gate opens, composed where it does not, and the pair loop or the
    single-field loop through ``ops/while_loop.py``), without the
    compensated dots or the composed backend; not the compensated
    residual."""
    n = p.shape[-1]
    if (not _even_pressure_ok(n, pres_cfg, p.dtype)
            or getattr(mom_cfg, "compensated_residual", False)):
        return False
    kind = getattr(mom_cfg, "kind", "")
    if kind == "chebyshev":
        return True
    if kind == "bicgstab":
        return (not getattr(mom_cfg, "compensated_dots", False)
                and getattr(mom_cfg, "backend", "auto") != "composed")
    return kind in ("jacobi", "rbgs") and supports_fused_assembly(
        n, n, "power_law", p.dtype, getattr(mom_cfg, "backend", "auto"), p.device)


def _vmapped_step(make_step, common, visc):
    """The lockstep step as ``torch.func.vmap`` of ``make_step(**common,
    mu=<one case's conductances>)``'s step over the cases: ``visc`` (B, 4)
    is each case's :func:`~naviflow_tpu_torch.ops.powerlaw.case_conductances`
    row, ``extra`` the carry with a case axis on every tensor (numbers, the
    lagged carry's age, are shared).  Each kernel of the step launches once
    for every case with the active flags (``_cuda.case_mask``); each frozen
    case then gets back its state, carry and ``info``."""

    def step(u, v, p, extra, active, info):
        leaves, build = _flatten(extra)
        out_build = []

        def one(u, v, p, leaves, visc):
            u2, v2, p2, extra2, info2 = make_step(**common, mu=visc)(u, v, p, build(leaves))
            leaves2, build2 = _flatten(extra2)
            out_build.append(build2)
            # a fixed cycle count is a number (multigrid_solve with
            # tolerance <= 0): a tensor of the loop's int32 here
            return u2, v2, p2, leaves2, tuple(
                x if torch.is_tensor(x) else torch.tensor(x, dtype=torch.int32, device=u2.device)
                for x in info2)

        with _cuda.case_mask(active):
            u2, v2, p2, leaves2, info2 = torch.func.vmap(one)(u, v, p, leaves, visc)

        def keep(new, old):
            return torch.where(active.view(-1, *(1,) * (new.dim() - 1)), new, old)

        info2 = StepInfo(*(keep(n, o) for n, o in zip(info2, info)))
        return (keep(u2, u), keep(v2, v), keep(p2, p),
                out_build[0]([keep(n, o) for n, o in zip(leaves2, leaves)]), info2)

    return step


def batched_cavity_solve(
    mesh: StructuredMesh,
    reynolds: Sequence[float],
    bc: BoundaryConditions,
    cfg,
    momentum,
    pressure,
    *,
    algorithm: str = "simple",
    rho: float = 1.0,
    dtype=torch.float32,
    device="cuda",
) -> List[Tuple[FlowState, SolveDiagnostics]]:
    """Solve one cavity grid for each Reynolds number, every case from rest,
    in one lockstep loop on ``device`` (the fused loop's semantics per
    case).  Returns per-case ``(state, diagnostics)``."""
    if algorithm not in _FAMILY:
        raise ValueError(f"Unknown algorithm: {algorithm}")
    make_step, carry0 = _FAMILY[algorithm]
    fluids = [FluidProperties(density=rho, reynolds_number=re) for re in reynolds]
    state = initialize_state(mesh, bc, dtype=dtype, device=device)
    dev, cases = state.u.device, len(fluids)
    dx, dy = mesh.get_cell_sizes()
    u0, v0, p0 = (torch.stack([x] * cases) for x in (state.u, state.v, state.p))
    refresh, every = None, 0
    if vmap_step_ok(state.p, cfg, momentum, pressure, algorithm):
        # the initial carry, built once (the lagged hierarchy has no mu:
        # one K4 launch), shared by every case (case stride 0)
        extra0_fn, every = lagged_extra0(mesh, pressure, cfg, dx, dy, rho, carry0(cfg))
        common = dict(dx=dx, dy=dy, rho=rho, bc=bc, cfg=cfg, mom_cfg=momentum,
                      pres_cfg=pressure)
        nx, ny = mesh.get_dimensions()
        if make_step is None and lagged_rho_enabled(
                nx, ny, momentum, fold_poisson=getattr(cfg, "fold_poisson", "auto") == "auto",
                dtype=dtype, device=dev):
            # K1's lagged Gershgorin carry, as simple_parts builds it
            extra0_fn, common["lagged_rho"] = rho_extra0(extra0_fn), True
        leaves, build = _flatten(extra0_fn(dtype, dev))
        extra0 = build([x.expand(cases, *x.shape) for x in leaves])
        visc = case_conductances([f.get_viscosity() for f in fluids], dx, dy, dtype, dev)
        make = make_step or make_simple_step
        step = _vmapped_step(make, common, visc)
        if every:
            refresh = _vmapped_step(make, dict(common, coarse_mode="rebuild"), visc)
    elif fused_step_ok(state.p, cfg, momentum, pressure, algorithm):
        carry = carry0(cfg)(dtype, dev)
        carry = carry if isinstance(carry, tuple) else (carry,)
        inf = torch.full((), float("inf"), dtype=dtype, device=dev)
        # the results a case frozen before its first step would hold: the
        # loop's initial norms
        sc0 = torch.stack([*carry, inf, inf, torch.zeros_like(inf)]).repeat(cases, 1)
        lag = None
        if uses_lagged_mg(pressure):  # the setup hierarchy: d = dy / dx, no mu; built once
            nx, ny = mesh.get_dimensions()
            lag = make_lagged_mg(pressure, dx=dx, dy=dy, rho=rho,
                                 variant=cfg.poisson_variant).extra0(dtype, nx, ny, dev)
        # every step is the same launch (K6 rebuilds the coarse operators
        # each step), so there is no refresh step
        step = _fused_step(algorithm, [f.get_viscosity() for f in fluids],
                           dict(dx=dx, dy=dy, rho=rho, bc=bc, cfg=cfg, mom_cfg=momentum,
                                pres_cfg=pressure))
        extra0 = (sc0, lag)
    else:
        args = (bc, cfg, momentum, pressure)
        parts = [simple_parts(mesh, f, *args, dtype=dtype, device=dev) if make_step is None
                 else family_parts(make_step, carry0(cfg), mesh, f, *args) for f in fluids]
        # the cases' initial carries are equal (the lagged hierarchy has no
        # mu): built once
        extra0 = [parts[0]["extra0_fn"](dtype, dev)] * cases
        step = _per_case([pt["step"] for pt in parts])
        if parts[0]["refresh_step"] is not None:
            refresh = _per_case([pt["refresh_step"] for pt in parts])
            every = parts[0]["refresh_every"]
    return run_outer_loop_batched(step, u0, v0, p0, extra0, max_iterations=cfg.max_iterations,
                                  tolerance=cfg.tolerance, dx=dx, dy=dy, refresh_step=refresh,
                                  refresh_every=every)
