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
  configuration at any of its levels, and the FMG headline at 255^2.  So
  do GMRES and IDR(s) momentum (``_gmres_masked``, ``_idrs_masked``; the
  shadow space drawn once, outside ``vmap``, and kept) and the pressure loops, with
  either arm's momentum: CG, BiCGSTAB and GMRES (``solvers/krylov.py``),
  Jacobi and red-black GS (``solvers/pressure.py``), and MGCG, whose
  preconditioner is a K3, or K2 strips and a K3 tail, an application for
  every case (the reference's job farm of AMG-preconditioned CG runs over
  SIMPLE, SIMPLEC, PISO and SIMPLER).  Both arms take the 9-point schemes
  (QUICK, LUDS, upwind: ``sweep --vmap --scheme quick``), whose momentum
  every kernel gate refuses, as the single step runs it: assembled
  composed (each case's conductances from its row), BiCGSTAB the
  single-field loop, GMRES, IDR(s), Jacobi and red-black GS composed,
  beside the arm's pressure kernels.  The odd arm also takes odd grids
  whose whole solve K5 cannot take (above 255^2: ``sweep --vmap --nx
  511``), with V-cycles: the Galerkin levels coarsened composed down to
  the first level K4's gate takes and K4 from there, each cycle's levels
  above its K3 tail composed and the tail one K3 for every case (the
  high-Re envelope of ``benchmarks/scale_runs.py``: 511^2 QUICK), and MGCG
  there, whose preconditioner is that V-cycle (``sweep --vmap --pressure
  mgcg --nx 511``).  Both arms take fixed-sweep Jacobi and red-black GS
  momentum composed, each case's conductances from its row, where K8 does
  not assemble it (``sweep --vmap --momentum rbgs`` at 63^2, ``--momentum
  jacobi|rbgs`` below 384^2), and the dense direct pressure solve
  (``--pressure direct``), its matrix built out of place and factored case
  by case;
* else every active case's own step, one after another (composed, or with
  its own kernels): the CPU path (where the kernel gates are closed), and
  every configuration the other two refuse: W and FMG cycles on even
  grids, and on odd grids whose whole solve K5 cannot take; the
  compensated residual and dots; 9-point Chebyshev momentum; the composed
  backend; and float64 wherever a kernel's gate decides the arm (on the
  card no kernel gate admits float64).

Each case's result is its single solve's: bit for bit in the K6 and per-case
branches, and in the vmapped one wherever the batched operators round as
the single ones do (the batched ``torch.mean`` of the pressure correction
and ``torch.linalg.vector_norm`` of the residuals do not, on the card; the
pressure loops' dots, norms and means, the multigrid loop's norms and its
correction's mean, the single-field BiCGSTAB's dots and the direct solve's
factorisation, mean and norms run case by case, through
``while_loop.case_by_case``, and so round as the single ones).
Viscosity is the one per-case scalar (cavity Re = rho U L / mu with U = L =
1).
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
from ..ops.highorder import SCHEME_WEIGHTS
from ..ops.mg import supports_fused_layout, supports_fused_rap
from ..ops.plane_strip import supports_plane_strip
from ..ops.powerlaw import case_conductances
from ..ops.stencil9 import Stencil9
from ..ops.step import ALGO_SCALARS, fused_outer_step_batched
from ..ops.strip import supports_strip
from ..ops.while_loop import flatten as _flatten
from ..solvers.momentum import idrs_shadow_space, lagged_rho_enabled
from ..solvers.multigrid import cycle_tail, galerkin_shapes, rap_start
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
    ``torch.func.vmap`` without a host read (the loops that read it run
    through ``ops/while_loop.py``).  Multigrid pressure takes one of two
    arms, by grid parity: :func:`_odd_step_ok` (K7, K5, K4: the FMG
    headline; K4, K3 where K5 cannot take the whole solve: 511^2) and
    :func:`_even_step_ok` (K1, K8, K9, K10, K2, K3 or K5: ``bench.py``'s
    large-grid SIMPLE, SIMPLEC, PISO and SIMPLER, the plane layout); the
    pressure loops (:func:`_loop_pressure_ok`: CG, BiCGSTAB, GMRES, MGCG,
    Jacobi, red-black GS) and the dense direct solve
    (:func:`_direct_pressure_ok`) take the momentum of the grid's arm;
    either arm takes the 9-point schemes (:func:`_nine_point_momentum_ok`)."""
    if not _cuda.kernel_device(p) or fused_step_ok(p, cfg, mom_cfg, pres_cfg, algorithm):
        return False
    nx, ny = p.shape[-2:]
    if nx != ny or _scheme(mom_cfg) not in ("power_law", *SCHEME_WEIGHTS):
        return False
    kind = getattr(pres_cfg, "kind", "")
    if kind == "multigrid":
        if pres_cfg.backend == "composed":
            return False
        if nx % 2:
            return _odd_step_ok(p, mom_cfg, pres_cfg)
        return _even_step_ok(p, cfg, mom_cfg, pres_cfg, algorithm)
    if not (_loop_pressure_ok(nx, pres_cfg, p.dtype) or _direct_pressure_ok(pres_cfg)):
        return False
    if nx % 2:
        return _odd_momentum_ok(p, mom_cfg)
    return _even_momentum_ok(p, mom_cfg)


def _loop_pressure_ok(n: int, pres_cfg, dtype) -> bool:
    """A pressure solve that is one loop through ``ops/while_loop.py``:
    CG, BiCGSTAB and GMRES (``solvers/krylov.py``), Jacobi and red-black GS
    (``solvers/pressure.py``), composed, on any square grid; MGCG where each
    preconditioner application is ``multigrid._cycle0``'s kernel path on
    the n^2 hierarchy of its ``mg`` (one K3; V-cycles of K2 strips above a
    K3 tail; or, on odd grids whose hierarchy K3 cannot take whole, the
    V-cycle of :func:`_odd_cycle_ok`), its backend not 'composed'."""
    kind = getattr(pres_cfg, "kind", "")
    if kind in ("cg", "bicgstab", "gmres", "jacobi", "rbgs"):
        return True
    if kind != "mgcg" or pres_cfg.mg.backend == "composed":
        return False
    mg = pres_cfg.mg
    layout = _layout(n, mg)
    if supports_fused_layout(layout, mg):  # K3
        return dtype == torch.float32
    if n % 2:
        return _odd_cycle_ok(n, mg, dtype)
    k = next((k for k in range(1, len(layout)) if supports_fused_layout(layout[k:], mg)), None)
    return k is not None and mg.cycle_type == "v" and all(
        supports_strip(*shp, five, mg, dtype) for shp, five in layout[:k])


def _direct_pressure_ok(pres_cfg) -> bool:
    """The dense direct solve (``solvers/pressure.py``
    ``solve_pressure_direct``), on either arm: its matrix built out of place
    from each case's coefficients, the factorisation, the mean and the
    norms case by case (``while_loop.case_by_case``).  It launches no
    kernel, as in the single step."""
    return getattr(pres_cfg, "kind", "") == "direct"


def _odd_step_ok(p, mom_cfg, pres_cfg) -> bool:
    """An odd square grid: multigrid pressure (Galerkin cycles) that
    :func:`_odd_pressure_ok` admits, and :func:`_odd_momentum_ok`."""
    return _odd_pressure_ok(p.shape[-1], pres_cfg, p.dtype) and _odd_momentum_ok(p, mom_cfg)


def _odd_pressure_ok(n: int, pres_cfg, dtype) -> bool:
    """``multigrid_solve``'s kernel path on an odd ``n``^2 vertex hierarchy,
    one of two: V or FMG cycles whose whole solve K5 takes and whose
    hierarchy K4 builds from the fine level (the FMG headline); or, where
    K5 cannot take the whole solve (odd grids above 255^2), V-cycles on
    ``build_levels``' hierarchy (Galerkin levels coarsened composed down to
    the first level K4's gate takes, ``multigrid.rap_start``, and K4 from
    there) whose cycle is ``multigrid._cycle0``'s peeled one
    (``multigrid.cycle_tail``: the levels above the first K3 tail
    composed, K3 on the tail), a fixed number of them or until the
    tolerance.  The dispatch of both is ``solvers/multigrid.py``'s own
    rule, read here on a hierarchy of ``dtype`` with no data."""
    layout = _layout(n, pres_cfg)
    if supports_fused_rap(n, n, pres_cfg, dtype) and supports_fused_layout(layout, pres_cfg):
        return True  # K4 from the fine level, K5 (its dtype: K4's gate)
    return _odd_cycle_ok(n, pres_cfg, dtype)


def _odd_cycle_ok(n: int, mg, dtype) -> bool:
    """V-cycles of the multigrid configuration ``mg`` on an odd ``n``^2
    vertex hierarchy whose whole solve K5 cannot take: ``build_levels``'
    levels coarsened composed down to ``multigrid.rap_start`` (not the
    last level) and K4 from there, each cycle ``multigrid._cycle0``'s peeled
    one (``multigrid.cycle_tail`` not None: the levels above the tail
    composed, K3 on the tail).  The pressure solve of the odd arm without
    K5 (:func:`_odd_pressure_ok`) and MGCG's preconditioner there
    (:func:`_loop_pressure_ok`) take it alike."""
    if mg.cycle_type != "v":
        return False
    layout = _layout(n, mg)
    z = torch.zeros((), dtype=dtype)
    levels = [(Stencil9(*[z] * 9), shp, five, None) for shp, five in layout]
    return (rap_start([shp for shp, _ in layout], mg, dtype) < len(layout) - 1
            and cycle_tail(levels, mg) is not None)


def _scheme(mom_cfg) -> str:
    return getattr(mom_cfg, "scheme", "power_law")


def _odd_momentum_ok(p, mom_cfg) -> bool:
    """The odd arm's momentum, without the one-pass assembly (K8):
    BiCGSTAB that K7 takes for both fields (its band form or, past the
    band's shared memory, its grid form: both batched), fixed-sweep
    Jacobi or red-black GS (``solvers/momentum.py``'s ``_jacobi_sweeps``
    and ``_rbgs_sweeps``, composed), or GMRES and IDR(s) (composed, their
    loops through ``ops/while_loop.py``), without the compensated
    residual; or a 9-point system (:func:`_nine_point_momentum_ok`)."""
    nx, ny = p.shape[-2:]
    if _scheme(mom_cfg) != "power_law":
        return _nine_point_momentum_ok(mom_cfg)
    if supports_fused_assembly(nx, ny, "power_law", p.dtype, getattr(mom_cfg, "backend", "auto"),
                               p.device):
        return False
    kind = getattr(mom_cfg, "kind", "")
    if kind in ("jacobi", "rbgs"):
        return True
    if kind in ("gmres", "idrs"):
        return not getattr(mom_cfg, "compensated_residual", False)
    return (kind == "bicgstab" and getattr(mom_cfg, "backend", "auto") != "composed"
            and supports_fused_bicgstab((nx + 1, ny), p.dtype)
            and supports_fused_bicgstab((nx, ny + 1), p.dtype))


def _nine_point_momentum_ok(mom_cfg) -> bool:
    """A 9-point system (QUICK, LUDS, upwind) on either arm, as the single
    step dispatches it: never K1, K7, K8 or K9 (every gate refuses it);
    BiCGSTAB the single-field ``_bicgstab_masked`` (not the pair loop,
    which takes five-point systems), GMRES and IDR(s) composed, their loops
    through ``ops/while_loop.py``, fixed-sweep Jacobi or red-black GS
    composed; not the compensated residual or dots, nor Chebyshev."""
    kind = getattr(mom_cfg, "kind", "")
    if getattr(mom_cfg, "compensated_residual", False) or getattr(mom_cfg, "compensated_dots",
                                                                  False):
        return False
    if kind in ("jacobi", "rbgs"):
        return True
    return (kind in ("bicgstab", "gmres", "idrs")
            and getattr(mom_cfg, "backend", "auto") != "composed")


def _layout(n: int, pres_cfg):
    """The ``((ni, nj), five_point)`` of each level of the Galerkin hierarchy
    of an ``n``^2 grid (``multigrid.build_levels``' shapes), finest
    first."""
    return [(shp, k == 0) for k, shp in enumerate(galerkin_shapes(n, n, pres_cfg))]


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
    layout = _layout(n, pres_cfg)
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
    """An even square grid: :func:`_even_pressure_ok` and
    :func:`_even_momentum_ok`."""
    return _even_pressure_ok(p.shape[-1], pres_cfg, p.dtype) and _even_momentum_ok(p, mom_cfg)


def _even_momentum_ok(p, mom_cfg) -> bool:
    """The even arm's momentum: Chebyshev (K1 through SIMPLE's lagged
    carry; else K8 and K9 where their gates open, composed where they do
    not), fixed-sweep Jacobi or red-black GS (their coefficients from K8
    where its gate opens, from 384^2, and composed with the case's
    conductance row where it does not), or BiCGSTAB as the single step
    dispatches it (K7 per field where its gate opens, band or grid form;
    else the coefficients from K8 where its gate opens, composed where it
    does not, and the pair loop or the single-field loop through
    ``ops/while_loop.py``), GMRES or IDR(s) (their coefficients so, their
    loops through ``ops/while_loop.py``), without the compensated dots or
    the composed backend; not the compensated residual."""
    if _scheme(mom_cfg) != "power_law":
        return _nine_point_momentum_ok(mom_cfg)
    if getattr(mom_cfg, "compensated_residual", False):
        return False
    kind = getattr(mom_cfg, "kind", "")
    if kind == "chebyshev":
        return True
    if kind in ("bicgstab", "gmres", "idrs"):
        return (not getattr(mom_cfg, "compensated_dots", False)
                and getattr(mom_cfg, "backend", "auto") != "composed")
    return kind in ("jacobi", "rbgs")


def _vmapped_step(make_step, common, visc):
    """The lockstep step as ``torch.func.vmap`` of ``make_step(**common,
    mu=<one case's conductances>)``'s step over the cases: ``visc`` (B, 4)
    is each case's :func:`~naviflow_tpu_torch.ops.powerlaw.case_conductances`
    row, ``extra`` the carry with a case axis on every tensor (numbers, the
    lagged carry's age, are shared).  Each kernel of the step
    launches once for every case with the active flags
    (``_cuda.case_mask``); each frozen case then gets back its state, carry
    and ``info``."""

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
        if getattr(momentum, "kind", "") == "idrs":
            # IDR(s)'s shadow spaces, drawn here (a draw raises under vmap)
            # and kept: the solves under vmap read them
            for shape in ((nx + 1, ny), (nx, ny + 1)):
                idrs_shadow_space(momentum.s, torch.Size(shape), dtype, dev)
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
