"""Shared outer-iteration harness for the SIMPLE-family algorithms (port of
``naviflow_tpu/algorithms/base.py``).

Each algorithm supplies ``step(u, v, p, extra) -> (u, v, p, extra,
StepInfo)``; the loop here owns convergence (``max(u_norm, v_norm) <= tol``,
read back on the host after every outer iteration), the history buffers and
the final diagnostics.  The JAX ``lax.while_loop`` becomes a Python loop;
``loop='fused'`` keeps its name and semantics.  The 'host' and 'chunked'
loop modes are not ported yet (ROADMAP §1 item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..core.state import FlowState
from ..ops.poisson import max_interior_divergence


class StepInfo(NamedTuple):
    u_norm: torch.Tensor
    v_norm: torch.Tensor
    p_norm: torch.Tensor
    inner_iterations: int
    r_u: torch.Tensor
    r_v: torch.Tensor
    r_p: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SolveDiagnostics:
    """Per-iteration histories (fixed-size buffers, valid up to ``iterations``)."""

    iterations: int
    converged: bool
    final_residual: torch.Tensor
    u_res_history: torch.Tensor  # (max_iterations,)
    v_res_history: torch.Tensor
    p_res_history: torch.Tensor
    total_res_history: torch.Tensor
    inner_iters_history: torch.Tensor  # (max_iterations,) int32
    u_residual_field: torch.Tensor
    v_residual_field: torch.Tensor
    p_residual_field: torch.Tensor
    max_divergence: torch.Tensor
    diverged: bool
    stalled: bool


def build_solver(step, *, max_iterations, tolerance, dx, dy, extra0_fn, loop: str,
                 refresh_step=None, refresh_every: int = 0):
    """Return ``solve(u0, v0, p0)`` for the requested loop mode.

    ``extra0_fn(dtype, device)`` builds the initial algorithm carry.
    ``refresh_step``/``refresh_every``: a periodic-variant step (the lagged
    multigrid rebuild) run as the first iteration of every
    ``refresh_every``-iteration block, i.e. at iterations 0, K, 2K, ..."""
    if loop == "auto":
        loop = "fused"
    if loop == "host" or loop.startswith("chunked"):
        raise NotImplementedError(
            f"loop={loop!r} is not ported yet (ROADMAP §1 item 7); use 'fused'")
    if loop != "fused":
        raise ValueError(f"Unknown loop mode: {loop}")

    def solve(u0, v0, p0, on_chunk=None):
        if on_chunk is not None:
            raise ValueError("on_chunk requires loop='chunked[:K]'")
        return run_outer_loop(
            step, u0, v0, p0, extra0_fn(u0.dtype, u0.device),
            max_iterations=max_iterations, tolerance=tolerance, dx=dx, dy=dy,
            refresh_step=refresh_step, refresh_every=refresh_every)

    return solve


def init_carry(u0, v0, p0, extra0, n: int):
    dtype, dev = u0.dtype, u0.device

    def zeros(dt=dtype):
        return torch.zeros((n,), dtype=dt, device=dev)

    return dict(
        u=u0, v=v0, p=p0, extra=extra0, it=0,
        total=torch.full((), float("inf"), dtype=dtype, device=dev),
        hist_u=zeros(), hist_v=zeros(), hist_p=zeros(), hist_total=zeros(),
        hist_inner=zeros(torch.int32),
        r_u=torch.zeros_like(u0), r_v=torch.zeros_like(v0), r_p=torch.zeros_like(p0),
    )


def make_body(step: Callable):
    """Carry -> carry body.  The history buffers belong to the carry (made
    by :func:`init_carry`), so they are written in place."""

    def body(c):
        u, v, p, extra, info = step(c["u"], c["v"], c["p"], c["extra"])
        dtype = c["total"].dtype
        total = torch.maximum(info.u_norm, info.v_norm).to(dtype)
        it = c["it"]
        c["hist_u"][it] = info.u_norm
        c["hist_v"][it] = info.v_norm
        c["hist_p"][it] = info.p_norm
        c["hist_total"][it] = total
        c["hist_inner"][it] = info.inner_iterations
        return dict(c, u=u, v=v, p=p, extra=extra, it=it + 1, total=total,
                    r_u=info.r_u, r_v=info.r_v, r_p=info.r_p)

    return body


def finalize(c, *, tolerance, dx, dy):
    total = c["total"]
    diag = SolveDiagnostics(
        iterations=c["it"],
        converged=bool(total <= tolerance),
        final_residual=total,
        u_res_history=c["hist_u"],
        v_res_history=c["hist_v"],
        p_res_history=c["hist_p"],
        total_res_history=c["hist_total"],
        inner_iters_history=c["hist_inner"],
        u_residual_field=c["r_u"],
        v_residual_field=c["r_v"],
        p_residual_field=c["r_p"],
        max_divergence=max_interior_divergence(c["u"], c["v"], dx=dx, dy=dy),
        diverged=not bool(torch.isfinite(total)),
        stalled=False,
    )
    return FlowState(u=c["u"], v=c["v"], p=c["p"]), diag


def run_outer_loop(
    step: Callable,
    u0,
    v0,
    p0,
    extra0: Any,
    *,
    max_iterations: int,
    tolerance: float,
    dx: float,
    dy: float,
    refresh_step=None,
    refresh_every: int = 0,
):
    """Run ``step`` until ``max(u_norm, v_norm) <= tolerance`` or
    ``max_iterations``, checking on the host after every iteration.

    With ``refresh_step``: every block runs one ``refresh_step`` iteration
    followed by up to ``refresh_every - 1`` plain ones."""
    n = max_iterations
    c = init_carry(u0, v0, p0, extra0, n)
    body = make_body(step)

    def going(c, limit):
        return c["it"] < limit and bool(c["total"] > tolerance)

    if refresh_step is None:
        while going(c, n):
            c = body(c)
        return finalize(c, tolerance=tolerance, dx=dx, dy=dy)

    body_r = make_body(refresh_step)
    while going(c, n):
        c = body_r(c)
        limit = min(c["it"] + (refresh_every - 1), n)
        while going(c, limit):
            c = body(c)
    return finalize(c, tolerance=tolerance, dx=dx, dy=dy)
