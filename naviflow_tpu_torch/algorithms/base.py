"""Shared outer-iteration harness for the SIMPLE-family algorithms (port of
``naviflow_tpu/algorithms/base.py``).

Each algorithm supplies ``step(u, v, p, extra) -> (u, v, p, extra,
StepInfo)``; the loop here owns convergence (``max(u_norm, v_norm) <= tol``,
read back on the host after every outer iteration), the history buffers and
the final diagnostics.  The JAX ``lax.while_loop`` becomes a Python loop.
The three loop modes keep their names and iteration semantics:

* ``'fused'``: stop at the first iteration with ``total <= tol``;
* ``'chunked[:K]'`` (K = 400 by default): fused chunks of up to K
  iterations, the lagged refresh at every chunk start, the stall detector
  and ``on_chunk`` between chunks;
* ``'host'``: ``check_every = 10`` iterations run unconditionally between
  checks (so it may overshoot convergence by up to 9), the stall detector
  after each check.
"""

from __future__ import annotations

import dataclasses
import math
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
    """Return ``solve(u0, v0, p0, on_chunk=None)`` for the requested loop mode.

    ``extra0_fn(dtype, device)`` builds the initial algorithm carry.
    ``refresh_step``/``refresh_every``: a periodic-variant step (the lagged
    multigrid rebuild) run as the first iteration of every
    ``refresh_every``-iteration block, i.e. at iterations 0, K, 2K, ..."""
    if loop == "auto":
        loop = "fused"
    common = dict(max_iterations=max_iterations, tolerance=tolerance, dx=dx, dy=dy,
                  refresh_step=refresh_step, refresh_every=refresh_every)
    if loop in ("fused", "host"):
        run = run_outer_loop if loop == "fused" else run_outer_loop_host

        def solve(u0, v0, p0, on_chunk=None):
            if on_chunk is not None:
                raise ValueError("on_chunk requires loop='chunked[:K]'")
            return run(step, u0, v0, p0, extra0_fn(u0.dtype, u0.device), **common)

        return solve
    if loop.startswith("chunked"):
        chunk = int(loop.split(":")[1]) if ":" in loop else 400

        def solve(u0, v0, p0, on_chunk=None):
            return run_outer_loop_chunked(step, u0, v0, p0, extra0_fn(u0.dtype, u0.device),
                                          chunk=chunk, on_chunk=on_chunk, **common)

        return solve
    raise ValueError(f"Unknown loop mode: {loop}")


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


def _going(c, limit, tolerance) -> bool:
    """The fused loop's condition: below ``limit`` and not converged (a
    non-finite residual stops it too)."""
    return c["it"] < limit and bool(c["total"] > tolerance)


def _run_to(c, limit, *, tolerance, body, body_r, refresh_every):
    """Iterate ``c`` as the fused loop does until ``limit`` or convergence;
    with ``body_r``, every block starts with one refresh iteration followed
    by up to ``refresh_every - 1`` plain ones."""
    if body_r is None:
        while _going(c, limit, tolerance):
            c = body(c)
        return c
    while _going(c, limit, tolerance):
        c = body_r(c)
        inner = min(c["it"] + (refresh_every - 1), limit)
        while _going(c, inner, tolerance):
            c = body(c)
    return c


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
    body_r = make_body(refresh_step) if refresh_step is not None else None
    c = _run_to(c, n, tolerance=tolerance, body=make_body(step), body_r=body_r,
                refresh_every=refresh_every)
    return finalize(c, tolerance=tolerance, dx=dx, dy=dy)


def case_info(info, b):
    """Case ``b``'s slice of a batched :class:`StepInfo`."""
    return StepInfo(*(x[b] for x in info))


def run_outer_loop_batched(
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
    """:func:`run_outer_loop` for B cases in lockstep, the leading axis of
    ``u0``, ``v0``, ``p0`` (the semantics of a vmapped ``lax.while_loop``):
    before each step ``active = (it_b < limit) & (total_b > tolerance)`` on
    the device (a non-finite residual stops its case), read on the host once
    a step for all cases (``active.any()``); every active case has taken the
    same number of steps, so the refresh blocks line up as in
    :func:`_run_to`.  ``step(u, v, p, extra, active, info)`` (and
    ``refresh_step``) steps every active case and hands each frozen one back
    its state, ``extra`` and ``info`` (the last step's :class:`StepInfo`,
    norms of shape (B,)); a case's history entries are written only while it
    is active.  Returns per-case ``(state, diagnostics)``, each what
    :func:`run_outer_loop` gives that case alone."""
    n = max_iterations
    cases, dtype, dev = u0.shape[0], u0.dtype, u0.device
    inf = torch.full((cases,), float("inf"), dtype=dtype, device=dev)
    c = dict(u=u0, v=v0, p=p0, extra=extra0, it=0,
             it_b=torch.zeros((cases,), dtype=torch.int64, device=dev), total=inf,
             info=StepInfo(u_norm=inf, v_norm=inf, p_norm=torch.zeros_like(inf),
                           inner_iterations=torch.zeros((cases,), dtype=torch.int32, device=dev),
                           r_u=torch.zeros_like(u0), r_v=torch.zeros_like(v0),
                           r_p=torch.zeros_like(p0)),
             # u, v, p and total residuals; the inner iterations
             hist=torch.zeros((cases, 4, n), dtype=dtype, device=dev),
             hist_inner=torch.zeros((cases, n), dtype=torch.int32, device=dev))

    def make(fn):
        def body(c, active):
            u, v, p, extra, info = fn(c["u"], c["v"], c["p"], c["extra"], active, c["info"])
            total = torch.maximum(info.u_norm, info.v_norm).to(dtype)
            it = c["it"]
            row = torch.stack([info.u_norm.to(dtype), info.v_norm.to(dtype),
                               info.p_norm.to(dtype), total], 1)
            c["hist"][:, :, it] = torch.where(active[:, None], row, c["hist"][:, :, it])
            c["hist_inner"][:, it] = torch.where(active, info.inner_iterations.to(torch.int32),
                                                 c["hist_inner"][:, it])
            return dict(c, u=u, v=v, p=p, extra=extra, it=it + 1, it_b=c["it_b"] + active,
                        total=total, info=info)

        return body

    body = make(step)
    body_r = make(refresh_step) if refresh_step is not None else None

    def going(c, limit):
        """The active mask below ``limit``, or None where no case is."""
        active = (c["it_b"] < limit) & (c["total"] > tolerance)
        return active if bool(active.any()) else None

    while (active := going(c, n)) is not None:
        if body_r is None:
            c = body(c, active)
            continue
        c = body_r(c, active)
        inner = min(c["it"] + (refresh_every - 1), n)
        while (active := going(c, inner)) is not None:
            c = body(c, active)
    out = []
    for b, it in enumerate(c["it_b"].tolist()):
        info = case_info(c["info"], b)
        hist = c["hist"][b]
        out.append(finalize(dict(u=c["u"][b], v=c["v"][b], p=c["p"][b], it=it,
                                 total=c["total"][b], hist_u=hist[0], hist_v=hist[1],
                                 hist_p=hist[2], hist_total=hist[3],
                                 hist_inner=c["hist_inner"][b], r_u=info.r_u, r_v=info.r_v,
                                 r_p=info.r_p), tolerance=tolerance, dx=dx, dy=dy))
    return out


class _StallDetector:
    """Residual change < 0.1% over a ~``window``-iteration span: stalled
    (logged in the diagnostics, the solve goes on).

    The host and chunked loops sample the residual once per
    ``sample_every`` iterations, so the window is tracked in samples:
    ``ceil(window / sample_every) + 1`` of them span >= ``window``
    iterations.  ``update`` returns the current verdict, re-evaluated at
    every sample."""

    def __init__(self, window: int = 50, sample_every: int = 10):
        self.n_samples = max(2, -(-window // max(sample_every, 1)) + 1)
        self.recent: list = []
        self.stalled = False

    def update(self, total: float) -> bool:
        self.recent.append(total)
        if len(self.recent) > self.n_samples:
            self.recent = self.recent[-self.n_samples:]
        if len(self.recent) == self.n_samples:
            lo, hi = min(self.recent), max(self.recent)
            avg = sum(self.recent) / len(self.recent)
            self.stalled = avg > 0 and (hi - lo) / avg < 1e-3
        return self.stalled


def _finalize_stall(c, detector, *, tolerance, dx, dy):
    state, diag = finalize(c, tolerance=tolerance, dx=dx, dy=dy)
    if detector.stalled:
        diag = dataclasses.replace(diag, stalled=True)
    return state, diag


def run_outer_loop_chunked(
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
    chunk: int = 400,
    on_chunk=None,
    refresh_step=None,
    refresh_every: int = 0,
):
    """Chunks of up to ``chunk`` iterations, each run as the fused loop
    runs (stopping at the first converged iteration), with the refresh at
    every chunk start and every ``refresh_every`` iterations within it.

    Between chunks: the stall detector's sample, then
    ``on_chunk(iteration, total, carry)`` (returning ``False`` stops the
    solve), then the stop on convergence, ``max_iterations`` or a
    non-finite residual.  Loop mode string: ``"chunked"`` or
    ``"chunked:<K>"``."""
    n = max_iterations
    body = make_body(step)
    body_r = make_body(refresh_step) if refresh_step is not None else None
    c = init_carry(u0, v0, p0, extra0, n)
    detector = _StallDetector(sample_every=chunk)
    while True:
        c = _run_to(c, min(c["it"] + chunk, n), tolerance=tolerance, body=body,
                    body_r=body_r, refresh_every=refresh_every)
        total = float(c["total"])
        it = c["it"]
        detector.update(total)
        if on_chunk is not None and on_chunk(it, total, c) is False:
            break
        if total <= tolerance or it >= n or not math.isfinite(total):
            break
    return _finalize_stall(c, detector, tolerance=tolerance, dx=dx, dy=dy)


def run_outer_loop_host(
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
    check_every: int = 10,
    refresh_step=None,
    refresh_every: int = 0,
):
    """Host-driven loop: ``check_every`` iterations run unconditionally
    between residual checks (the refresh step where ``(done + i) %
    refresh_every == 0``); stop on convergence or a non-finite residual,
    else sample the stall detector."""
    n = max_iterations
    body = make_body(step)
    body_r = make_body(refresh_step) if refresh_step is not None else None
    c = init_carry(u0, v0, p0, extra0, n)
    done = 0
    detector = _StallDetector(sample_every=check_every)
    while done < n:
        k = min(check_every, n - done)
        for i in range(k):
            refresh = body_r is not None and (done + i) % refresh_every == 0
            c = body_r(c) if refresh else body(c)
        done += k
        total = float(c["total"])
        if total <= tolerance or not math.isfinite(total):
            break
        detector.update(total)
    return _finalize_stall(c, detector, tolerance=tolerance, dx=dx, dy=dy)
