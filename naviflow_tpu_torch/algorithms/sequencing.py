"""Grid sequencing and Reynolds continuation (port of
``naviflow_tpu/algorithms/sequencing.py``).

SIMPLE needs O(nx) outer iterations for the flow to develop from rest.
Grid sequencing solves the cavity on a ladder of coarser grids first and
warm-starts each finer level from the interpolated coarse solution;
Reynolds continuation walks a schedule of Reynolds numbers, warm-starting
each from the last.  Each level is one call of an algorithm entry point
(``simple_solve`` and its siblings) on the device of the state.

Staggered warm starts interpolate each field bilinearly
(``F.interpolate(mode='bilinear', align_corners=False)``, the same
half-pixel rule as the JAX package's ``jax.image.resize(method='linear')``
when upsampling); the velocity BCs are applied afterwards.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..core.bc import BoundaryConditions, apply_velocity_bcs
from ..core.fluid import FluidProperties
from ..core.mesh import StructuredMesh
from ..core.state import FlowState, initialize_state


def coarsen_size(nx: int) -> int:
    """One ladder step preserving grid parity: 2^k -> 2^(k-1),
    2^k - 1 -> 2^(k-1) - 1."""
    return nx // 2 if nx % 2 == 0 else (nx - 1) // 2


def build_ladder(nx: int, *, coarsest: int = 32, max_levels: int = 6) -> List[int]:
    """Fine-to-coarse ladder [nx, nx/2, ...] down to ~``coarsest``."""
    ladder = [nx]
    while len(ladder) < max_levels and coarsen_size(ladder[-1]) >= coarsest:
        ladder.append(coarsen_size(ladder[-1]))
    return ladder


def _resize(x, shape):
    return F.interpolate(x[None, None], size=tuple(shape), mode="bilinear",
                         align_corners=False)[0, 0]


def prolong_state(state: FlowState, mesh_fine: StructuredMesh,
                  bc: BoundaryConditions) -> FlowState:
    """Interpolate a staggered state to a finer mesh (bilinear), then
    re-apply the velocity BCs."""
    u = _resize(state.u, mesh_fine.u_shape)
    v = _resize(state.v, mesh_fine.v_shape)
    p = _resize(state.p, mesh_fine.p_shape)
    u, v = apply_velocity_bcs(u, v, bc)
    return FlowState(u=u, v=v, p=p)


def _perturbed(state: FlowState, seed: int) -> FlowState:
    """O(1e-7) uniform noise on the pressure, from a seeded generator on the
    state's device (not the JAX package's PRNG bits)."""
    g = torch.Generator(device=state.p.device).manual_seed(seed)
    noise = torch.rand(state.p.shape, generator=g, dtype=state.p.dtype,
                       device=state.p.device) * 1e-7
    return state.replace(p=state.p + noise)


def _summary(diag, **kw):
    return dict(**kw, iterations=int(diag.iterations), converged=bool(diag.converged),
                final_residual=float(diag.final_residual))


def reynolds_continuation_solve(
    mesh: StructuredMesh,
    reynolds_schedule,
    bc: BoundaryConditions,
    solve_fn,
    cfg,
    *,
    momentum,
    pressure,
    loop: str = "auto",
    state: FlowState = None,
    density: float = 1.0,
    per_re_cfg=None,
    device="cuda",
) -> Tuple[FlowState, object, list]:
    """Continuation in Reynolds number: solve at each Re in the schedule,
    warm-starting from the previous converged state (from rest on
    ``device`` where ``state`` is None).  ``per_re_cfg`` optionally maps
    Re -> algorithm config."""
    summaries = []
    diag = None
    for re in reynolds_schedule:
        fluid = FluidProperties(density=density, reynolds_number=re)
        level_cfg = per_re_cfg(re) if per_re_cfg else cfg
        if state is None:
            state = initialize_state(mesh, bc, device=device)
        state, diag = solve_fn(mesh, fluid, bc, state, level_cfg,
                               momentum=momentum, pressure=pressure, loop=loop)
        summaries.append(_summary(diag, reynolds=re))
    return state, diag, summaries


def sequenced_continuation_solve(
    mesh: StructuredMesh,
    reynolds_schedule,
    bc: BoundaryConditions,
    solve_fn,
    cfg,
    *,
    momentum,
    pressure,
    loop: str = "auto",
    coarsest: int = 32,
    max_levels: int = 6,
    dtype=torch.float32,
    device="cuda",
    per_re_cfg=None,
    per_level_cfg=None,
    perturb_seed: int = None,
) -> Tuple[FlowState, object, list]:
    """Grid sequencing composed with Reynolds continuation: the whole
    schedule at the coarsest ladder level, then each finer level at the
    target (last) Re only, warm-started from the prolonged coarse state.

    ``per_re_cfg(re) -> cfg`` customizes the coarsest-level continuation;
    ``per_level_cfg(nx) -> cfg`` the refinement levels.  ``perturb_seed``
    adds O(1e-7) noise to the coarsest initial pressure from a seeded
    ``torch.Generator`` (its bits differ from the JAX package's)."""
    ladder = build_ladder(mesh.nx, coarsest=coarsest, max_levels=max_levels)
    summaries = []
    re_target = reynolds_schedule[-1]

    nx_c = ladder[-1]
    coarse_mesh = StructuredMesh(nx=nx_c, ny=nx_c, length=mesh.length, height=mesh.height)
    state = initialize_state(coarse_mesh, bc, dtype, device=device)
    if perturb_seed is not None:
        state = _perturbed(state, perturb_seed)
    state, diag, cont_summ = reynolds_continuation_solve(
        coarse_mesh, reynolds_schedule, bc, solve_fn, cfg,
        momentum=momentum, pressure=pressure, loop=loop, state=state,
        per_re_cfg=per_re_cfg)
    summaries.append(dict(nx=nx_c, continuation=cont_summ))

    fluid = FluidProperties(density=1.0, reynolds_number=re_target)
    for nx in reversed(ladder[:-1]):
        level_mesh = StructuredMesh(nx=nx, ny=nx, length=mesh.length, height=mesh.height)
        state = prolong_state(state, level_mesh, bc)
        level_cfg = per_level_cfg(nx) if per_level_cfg else cfg
        state, diag = solve_fn(level_mesh, fluid, bc, state, level_cfg,
                               momentum=momentum, pressure=pressure, loop=loop)
        summaries.append(_summary(diag, nx=nx, reynolds=re_target))
    return state, diag, summaries


def grid_sequence_solve(
    mesh: StructuredMesh,
    fluid: FluidProperties,
    bc: BoundaryConditions,
    solve_fn,
    cfg,
    *,
    momentum,
    pressure,
    loop: str = "auto",
    coarsest: int = 32,
    max_levels: int = 6,
    dtype=torch.float32,
    device="cuda",
    perturb_seed: int = None,
    per_level_momentum=None,
) -> Tuple[FlowState, object, list]:
    """Solve on a coarse-to-fine mesh ladder, warm-starting each level.

    ``solve_fn`` is an algorithm entry point (e.g. ``simple_solve``);
    ``cfg`` applies at every level.  The coarsest level starts from rest on
    ``device``; ``perturb_seed`` adds O(1e-7) noise to its pressure from a
    seeded ``torch.Generator``.  ``per_level_momentum`` optionally maps
    nx -> momentum config.  Returns the fine state, the fine-level
    diagnostics and a per-level summary list."""
    ladder = build_ladder(mesh.nx, coarsest=coarsest, max_levels=max_levels)
    summaries = []
    state = None
    diag = None
    for nx in reversed(ladder):
        level_mesh = StructuredMesh(nx=nx, ny=nx, length=mesh.length, height=mesh.height)
        if state is None:
            state = initialize_state(level_mesh, bc, dtype, device=device)
            if perturb_seed is not None:
                state = _perturbed(state, perturb_seed)
        else:
            state = prolong_state(state, level_mesh, bc)
        mom = per_level_momentum(nx) if per_level_momentum else momentum
        state, diag = solve_fn(level_mesh, fluid, bc, state, cfg,
                               momentum=mom, pressure=pressure, loop=loop)
        summaries.append(_summary(diag, nx=nx))
    return state, diag, summaries
