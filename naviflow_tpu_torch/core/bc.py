"""Boundary-condition registry and functional application (port of
``naviflow_tpu/core/bc.py``).

Semantics preserved exactly (staggered shapes u=(nx+1,ny), v=(nx,ny+1)):
1. every boundary is first zeroed (wall default);
2. sides registered with a VELOCITY condition overwrite their boundary slab
   with the given (u, v) values:  top -> u[:, ny-1], v[:, ny];
   bottom -> u[:, 0], v[:, 0]; left -> u[0, :], v[0, :];
   right -> u[nx, :], v[nx-1, :].

The window variant :func:`apply_velocity_bcs_window` applies the same rule
to a domain-decomposed block, with the boundary slabs as masks over global
indices.
"""

from __future__ import annotations

import dataclasses
import functools
from enum import Enum
from typing import Optional

import torch


class BoundaryType(Enum):
    WALL = "wall"
    VELOCITY = "velocity"
    PRESSURE = "pressure"
    INFLOW = "inflow"
    OUTFLOW = "outflow"
    SYMMETRY = "symmetry"


class BoundaryLocation(Enum):
    TOP = "top"
    BOTTOM = "bottom"
    LEFT = "left"
    RIGHT = "right"


_SIDES = ("top", "bottom", "left", "right")


@dataclasses.dataclass(frozen=True)
class SideCondition:
    """Condition on one side of the domain."""

    kind: BoundaryType = BoundaryType.WALL
    u: float = 0.0
    v: float = 0.0


@dataclasses.dataclass(frozen=True)
class BoundaryConditions:
    """Immutable set of conditions for all four sides."""

    top: SideCondition = SideCondition()
    bottom: SideCondition = SideCondition()
    left: SideCondition = SideCondition()
    right: SideCondition = SideCondition()

    def with_condition(
        self, location, bc_type, values: Optional[dict] = None
    ) -> "BoundaryConditions":
        if isinstance(location, BoundaryLocation):
            location = location.value
        location = location.lower()
        if location not in _SIDES:
            raise ValueError(f"Unknown boundary location: {location}")
        if isinstance(bc_type, str):
            bc_type = BoundaryType(bc_type.lower())
        values = values or {}
        side = SideCondition(
            kind=bc_type, u=float(values.get("u", 0.0)), v=float(values.get("v", 0.0))
        )
        return dataclasses.replace(self, **{location: side})

    def side(self, name: str) -> SideCondition:
        return getattr(self, name)

    def get_boundary_types(self) -> dict:
        return {s: self.side(s).kind.value for s in _SIDES}

    def apply_to_velocity(self, u, v):
        return apply_velocity_bcs(u, v, self)


def lid_driven_cavity(lid_velocity: float = 1.0) -> BoundaryConditions:
    """Standard lid-driven cavity: moving top lid, no-slip walls elsewhere."""
    return BoundaryConditions().with_condition(
        "top", BoundaryType.VELOCITY, {"u": lid_velocity}
    )


@functools.lru_cache(maxsize=64)
def _velocity_slabs(nx, ny, bc: BoundaryConditions, u_dtype, v_dtype, device):
    """``(mask_u, value_u, mask_v, value_v)``: the boundary nodes of u and
    v and the value each ends with (zero, then each VELOCITY side's value
    in ``_SIDES`` order, so a corner belongs to the later side), built
    once per grid, conditions, dtype and device."""
    out = []
    for shape, dtype, slabs, comp in (
            ((nx + 1, ny), u_dtype, {"top": (slice(None), ny - 1), "bottom": (slice(None), 0),
                                     "left": (0, slice(None)), "right": (nx, slice(None))}, "u"),
            ((nx, ny + 1), v_dtype, {"top": (slice(None), ny), "bottom": (slice(None), 0),
                                     "left": (0, slice(None)), "right": (nx - 1, slice(None))},
             "v")):
        mask = torch.zeros(shape, dtype=torch.bool, device=device)
        value = torch.zeros(shape, dtype=dtype, device=device)
        for name in _SIDES:
            mask[slabs[name]] = True
        for name in _SIDES:
            s = bc.side(name)
            if s.kind == BoundaryType.VELOCITY:
                value[slabs[name]] = getattr(s, comp)
        out += [mask, value]
    return tuple(out)


def apply_velocity_bcs(u, v, bc: BoundaryConditions):
    """All boundaries are zeroed, then VELOCITY sides are overwritten
    (corners owned by the later side in ``_SIDES`` order).  Returns new
    tensors, out of place (one ``where`` a field, so ``torch.func``
    transforms and traces see no write into a tensor); never mutates its
    inputs."""
    nxp1, ny = u.shape
    mask_u, value_u, mask_v, value_v = _velocity_slabs(nxp1 - 1, ny, bc, u.dtype, v.dtype,
                                                       u.device)
    return torch.where(mask_u, value_u, u), torch.where(mask_v, value_v, v)


def apply_velocity_bcs_window(u_loc, v_loc, bc: BoundaryConditions, *, gi0, gj0, nx, ny):
    """Window form of :func:`apply_velocity_bcs` for domain-decomposed
    blocks: boundary slabs become masks over global indices.

    ``u_loc``: (nxl+1, nyl) faces gi0.. x cells gj0..; ``v_loc``:
    (nxl, nyl+1).  The same semantics as the global function (zero all
    boundary slabs, then VELOCITY sides overwrite in top/bottom/left/right
    order, corners owned by the velocity side).  ``gi0``/``gj0`` are ints.
    """
    dev = u_loc.device
    GIu = gi0 + torch.arange(u_loc.shape[0], dtype=torch.int32, device=dev).view(-1, 1)
    GJu = gj0 + torch.arange(u_loc.shape[1], dtype=torch.int32, device=dev).view(1, -1)
    GIv = gi0 + torch.arange(v_loc.shape[0], dtype=torch.int32, device=dev).view(-1, 1)
    GJv = gj0 + torch.arange(v_loc.shape[1], dtype=torch.int32, device=dev).view(1, -1)
    u_masks = {"top": GJu == ny - 1, "bottom": GJu == 0, "left": GIu == 0,
               "right": GIu == nx}
    v_masks = {"top": GJv == ny, "bottom": GJv == 0, "left": GIv == 0,
               "right": GIv == nx - 1}
    zero = torch.zeros((), dtype=u_loc.dtype, device=dev)
    u, v = u_loc, v_loc
    for name in _SIDES:
        u = torch.where(u_masks[name], zero, u)
        v = torch.where(v_masks[name], zero, v)
    for name in _SIDES:
        s = bc.side(name)
        if s.kind != BoundaryType.VELOCITY:
            continue
        u = torch.where(u_masks[name], torch.full((), s.u, dtype=u.dtype, device=dev), u)
        v = torch.where(v_masks[name], torch.full((), s.v, dtype=v.dtype, device=dev), v)
    return u, v


def enforce_pressure_bcs(p, bc: BoundaryConditions):
    """Zero-gradient (Neumann) pressure boundary enforcement: each boundary
    slab copies its first interior neighbor, in top, bottom, left, right
    order."""
    nx, ny = p.shape
    p = p.clone()
    # in place on the fresh copy; each copy reads the slab state left by
    # the previous one, as the JAX chain of selects does
    p[:, ny - 1] = p[:, ny - 2].clone()
    p[:, 0] = p[:, 1].clone()
    p[0, :] = p[1, :].clone()
    p[nx - 1, :] = p[nx - 2, :].clone()
    return p
