"""Carry state and configuration across from the JAX package.

The functions here take the JAX package's objects duck-typed — arrays as
anything ``numpy.asarray`` reads, dataclasses by their field names — so this
module imports neither JAX nor ``naviflow_tpu``.  With them both packages
compute the same thing from the same inputs in the tests.

Config classes map by name onto the port's classes with the same fields;
``backend='pallas'`` becomes ``'kernel'`` and ``backend='xla'`` becomes
``'composed'``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.bc import BoundaryConditions, BoundaryType, SideCondition
from .core.fluid import FluidProperties
from .core.mesh import StructuredMesh
from .core.state import FlowState
from .ops.poisson import PoissonCoeffs
from .ops.stencil import StencilCoeffs
from .ops.stencil9 import Stencil9

_BACKENDS = {"pallas": "kernel", "xla": "composed"}


def tensor(x, *, dtype=None, device=None) -> torch.Tensor:
    """A JAX array (or anything numpy reads) as a tensor on ``device``."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _fields(obj, cls, dtype, device):
    return cls(**{f.name: tensor(getattr(obj, f.name), dtype=dtype, device=device)
                  for f in dataclasses.fields(cls)})


def flow_state(state, *, dtype=None, device=None) -> FlowState:
    return _fields(state, FlowState, dtype, device)


def stencil_coeffs(c, *, dtype=None, device=None) -> StencilCoeffs:
    return _fields(c, StencilCoeffs, dtype, device)


def poisson_coeffs(c, *, dtype=None, device=None) -> PoissonCoeffs:
    return _fields(c, PoissonCoeffs, dtype, device)


def stencil9(st, *, dtype=None, device=None) -> Stencil9:
    return _fields(st, Stencil9, dtype, device)


def coarse_tuple(coarse, *, dtype=None, device=None):
    """The lagged multigrid carry ``(age, (Stencil9, ...))``, or a bare
    tuple of coarse stencils."""
    if len(coarse) == 2 and not hasattr(coarse[0], "c"):
        age, sts = coarse
        return int(np.asarray(age)), coarse_tuple(sts, dtype=dtype, device=device)
    return tuple(stencil9(st, dtype=dtype, device=device) for st in coarse)


def _port_config_classes():
    from .algorithms.simple import SIMPLEConfig
    from .solvers.momentum import (ChebyshevMomentumConfig, JacobiMomentumConfig,
                                   KrylovMomentumConfig)
    from .solvers.multigrid import MultigridConfig
    from .solvers.pressure import RBGSPressureConfig

    return {c.__name__: c for c in (
        SIMPLEConfig, ChebyshevMomentumConfig, JacobiMomentumConfig,
        KrylovMomentumConfig, MultigridConfig, RBGSPressureConfig)}


def config(cfg):
    """The port's config dataclass for a JAX config dataclass."""
    classes = _port_config_classes()
    name = type(cfg).__name__
    if name not in classes:
        raise NotImplementedError(f"{name} has no counterpart in the port yet")
    kw = {}
    for f in dataclasses.fields(classes[name]):
        val = getattr(cfg, f.name)
        if f.name == "backend":
            val = _BACKENDS.get(val, val)
        kw[f.name] = val
    return classes[name](**kw)


def mesh(m) -> StructuredMesh:
    return StructuredMesh(nx=m.nx, ny=m.ny, length=m.length, height=m.height)


def fluid(f) -> FluidProperties:
    return FluidProperties(density=f.density, viscosity=f.viscosity,
                           reynolds_number=f.reynolds_number,
                           characteristic_velocity=f.characteristic_velocity,
                           characteristic_length=f.characteristic_length)


def boundary_conditions(bc) -> BoundaryConditions:
    sides = {}
    for name in ("top", "bottom", "left", "right"):
        s = getattr(bc, name)
        sides[name] = SideCondition(kind=BoundaryType(s.kind.value), u=s.u, v=s.v)
    return BoundaryConditions(**sides)
