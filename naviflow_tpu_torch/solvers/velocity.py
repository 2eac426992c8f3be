"""Velocity corrector (port of ``naviflow_tpu/solvers/velocity.py``):
u = u* + d_u (p'_W - p'_P), v = v* + d_v (p'_S - p'_P) on interior nodes,
then velocity BCs are re-applied."""

from __future__ import annotations

import torch

from ..core.bc import BoundaryConditions, apply_velocity_bcs
from ..ops.stencil import interior_mask, pad2


def update_velocity(u_star, v_star, p_prime, d_u, d_v, bc: BoundaryConditions):
    dev = u_star.device
    grad_u = pad2(p_prime[:-1, :] - p_prime[1:, :], 1, 1)
    u = torch.where(interior_mask(u_star.shape, 1, 1, 1, 1, device=dev),
                    u_star + d_u * grad_u, u_star)
    grad_v = pad2(p_prime[:, :-1] - p_prime[:, 1:], 0, 0, 1, 1)
    v = torch.where(interior_mask(v_star.shape, 1, 1, 1, 1, device=dev),
                    v_star + d_v * grad_v, v_star)
    return apply_velocity_bcs(u, v, bc)
