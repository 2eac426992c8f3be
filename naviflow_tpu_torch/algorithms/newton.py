"""Steady Newton–Krylov (JFNK) solver for the coupled momentum + continuity
system (port of ``naviflow_tpu/algorithms/newton.py``).

Unknown w = (u, v, p) on the staggered grid, flattened.  Residual F(w):

* momentum blocks: the unrelaxed discrete momentum residuals, oriented
  ``A(u, v) x - src(u, v, p)`` on interior nodes (the SIMPLE loop's
  convergence norms up to sign);
* continuity block: the mean-projected continuity defect
  ``pressure_rhs(u, v)`` (removes the p-gauge's null vectors).

Jacobian-vector products are exact forward-mode derivatives, split as
``jax.linearize`` splits them: ``make_fx`` traces ``torch.func.jvp`` of F
once per solve, with the iterate w and the direction z as the graph's
inputs (:func:`split_linearization`); the nodes that do not depend on z
run once per linearization, and each GMRES iteration runs only the
tangent nodes (on one CPU core at 63^2: 6 ms a product for the QUICK
residual, where ``torch.func.jvp`` takes 48 ms and ``torch.func.linearize``
retraces for 4 s a linearization).  On the card the tangent program's
1,400-odd launches are one CUDA graph (:class:`GraphedTangent`).  The trace needs F free of in-place
writes (an in-place boundary write on a fresh copy kept the boundary
tangents in a ``make_fx`` trace): ``apply_velocity_bcs``, ``where_set``
and ``where_add`` are out of place.  F goes through the
plain PyTorch assembly (``solvers.momentum._assemble_coeffs``), never a
kernel: the ``ctypes`` kernels have no forward-mode rule, and every kernel
gate raises under a transform (``ops._cuda.refuse_under_transform``).

The linear solve is right-preconditioned restarted GMRES
(``solvers/krylov.gmres_solve`` on the flat state) with a SIMPLE-type
block preconditioner frozen at the Newton iterate: diagonal (or a few
Jacobi sweeps of the) momentum solves plus one multigrid pressure
projection.  The preconditioner is not differentiated; its
``multigrid_solve`` runs through the kernel gates, so on the card a
vertex hierarchy is built by K4 (once per linearization: the hierarchy
depends only on the frozen iterate) and each application is one K5
launch where the gate admits the hierarchy.

Globalization: pseudo-transient continuation (Kelley & Keyes) with a
linear-solve-aware SER ``dtau`` schedule, and a backtracking line search
on ||F||, a Python loop with host reads (the JAX package's
``lax.while_loop``).  The outer loop is host-driven in both packages.
The JAX package's sharded Newton step (GSPMD placement of the flat state)
has no counterpart here, as ``parallel/sharding.py``'s GSPMD helpers have
none.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.fx as fx
from torch.fx.experimental.proxy_tensor import make_fx

from ..core.bc import BoundaryConditions, apply_velocity_bcs
from ..core.fluid import FluidProperties
from ..core.mesh import StructuredMesh
from ..core.state import FlowState
from ..ops.poisson import pressure_rhs
from ..ops.powerlaw import d_coefficient
from ..ops.stencil import pad2
from ..solvers.krylov import gmres_solve
from ..solvers.momentum import (_apply, _assemble_coeffs, _u_interior_mask,
                                _unrelaxed_residual, _v_interior_mask)
from ..solvers.multigrid import MultigridConfig, build_levels, multigrid_solve


@dataclasses.dataclass(frozen=True)
class NewtonDiagnostics:
    """Newton-run record.  ``final_residual`` is max(||r_u||, ||r_v||), the
    interior-L2 unrelaxed momentum norms the SIMPLE-family loops converge
    on."""

    converged: bool
    iterations: int
    final_residual: float
    residual_history: tuple
    gmres_iterations: int


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """JFNK configuration (the JAX package's fields and defaults)."""

    max_newton: int = 40
    tolerance: float = 1e-5  # on max(||r_u||, ||r_v||)
    scheme: str = "quick"  # power_law | quick | luds
    # inexact-Newton forcing: GMRES solves to ||J d + F|| <= eta ||F||
    gmres_tol: float = 1e-2
    gmres_restart: int = 60
    gmres_maxiter: int = 240
    max_backtracks: int = 5
    # multigrid cycles of the preconditioner's pressure projection (at least)
    precond_cycles: int = 4
    # Jacobi sweeps on the momentum blocks inside the preconditioner
    momentum_sweeps: int = 1
    # damping of the first two Newton steps (1.0 = full Newton)
    initial_damping: float = 1.0
    # pseudo-transient continuation: solve (rho dx dy / dtau + J) d = -F;
    # dtau0 = 0 is plain Newton
    dtau0: float = 0.5
    dtau_max: float = 1e8
    ser_growth: float = 4.0
    # 0: the whole GMRES solve per Newton step; k > 0: k restart cycles per
    # chunk, re-linearized at the frozen iterate, early exit between chunks
    gmres_chunk: int = 0


def _flatten(u, v, p):
    return torch.cat([u.reshape(-1), v.reshape(-1), p.reshape(-1)])


def _unflatten(w, su, sv, sp):
    nu = su[0] * su[1]
    nv = sv[0] * sv[1]
    return (w[:nu].reshape(su), w[nu:nu + nv].reshape(sv), w[nu + nv:].reshape(sp))


def _masked(mask, x):
    return torch.where(mask, x, torch.zeros_like(x))


def make_residual(*, dx, dy, rho, mu, bc: BoundaryConditions, scheme: str, su, sv, sp):
    """Flat residual F: R^N -> R^N (momentum blocks + projected continuity
    block), plain PyTorch end to end, so ``torch.func`` differentiates
    it."""
    masks = {}

    def F(w):
        dev = w.device
        if dev not in masks:
            masks[dev] = (_u_interior_mask(su, device=dev), _v_interior_mask(sv, device=dev))
        u_mask, v_mask = masks[dev]
        u, v, p = _unflatten(w, su, sv, sp)
        u, v = apply_velocity_bcs(u, v, bc)
        kw = dict(dx=dx, dy=dy, rho=rho, mu=mu, scheme=scheme)
        c_u = _assemble_coeffs(u, v, p, is_u=True, **kw)
        c_v = _assemble_coeffs(u, v, p, is_u=False, **kw)
        # momentum rows A x - src: the Jacobian's momentum block is +A-like,
        # which the SIMPLE preconditioner (~ +A^-1) matches
        r_u = _masked(u_mask, _apply(u, c_u) - c_u.src)
        r_v = _masked(v_mask, _apply(v, c_v) - c_v.src)
        r_c = pressure_rhs(u, v, dx=dx, dy=dy, rho=rho, pin=False)
        r_c = r_c - torch.mean(r_c)  # project the left null vector
        return _flatten(r_u, r_v, r_c)

    return F


# the residual's configuration, dtype and device -> its linearization; the
# most recent few are kept (a CUDA graph holds its intermediates' memory)
_LINEARIZATIONS = {}
_KEEP_LINEARIZATIONS = 4


def split_linearization(F, w):
    """``linearize(w) -> (F(w), jvp)`` for F at any iterate of ``w``'s
    shape, dtype and device, from one trace of ``torch.func.jvp(F, (w,),
    (z,))`` with w and z as inputs (functionalized: no node writes into a
    tensor).  The nodes that depend only on w form the primal program, run
    once per linearization; the nodes that depend on z form the tangent
    program, run once per product on the primal program's outputs."""

    def tangent(w, z):
        return torch.func.jvp(F, (w,), (z,))[1]

    # one eager call first: the constants F caches (masks, boundary values)
    # are made outside the trace, where functionalization would wrap them
    F(w)
    gm = make_fx(torch.func.functionalize(tangent, remove="mutations_and_views"))(
        w, torch.zeros_like(w))
    nodes = list(gm.graph.nodes)
    z_node = [n for n in nodes if n.op == "placeholder"][1]
    on_z = {z_node}
    for n in nodes:
        if n.op == "call_function" and any(a in on_z for a in n.all_input_nodes):
            on_z.add(n)
    # the primal values the tangent nodes read (constants are copied as such)
    boundary = [n for n in nodes if n.op not in ("get_attr", "output") and n not in on_z
                and any(u in on_z for u in n.users)]
    primal, env = fx.Graph(), {}
    for n in nodes:
        if n not in on_z and n.op != "output":
            env[n] = primal.node_copy(n, lambda a: env[a])
    primal.output(tuple(env[n] for n in boundary))
    primal.eliminate_dead_code()
    tan, env = fx.Graph(), {}
    for n in boundary:
        env[n] = tan.placeholder(f"{n.name}_primal")
    env[z_node] = tan.placeholder("z")
    for n in nodes:
        if n.op == "get_attr" or (n in on_z and n is not z_node):
            env[n] = tan.node_copy(n, lambda a: env[a])
        elif n.op == "output":
            tan.output(fx.map_arg(n.args[0], lambda a: env[a]))
    tan.eliminate_dead_code()
    primal_fn, tangent_fn = fx.GraphModule(gm, primal), fx.GraphModule(gm, tan)
    graphed = []  # the tangent program as one CUDA graph (a CUDA iterate)

    def linearize(w):
        values = primal_fn(w)
        if not w.is_cuda:
            return F(w), lambda z: tangent_fn(*values, z)
        if not graphed:
            graphed.append(GraphedTangent(tangent_fn, values, w))
        return F(w), graphed[0].bind(values)

    return linearize


class GraphedTangent:
    """The tangent program captured once as a CUDA graph over static input
    buffers: a product copies z in, replays the graph (one launch in place
    of some 1,400) and clones the output.  ``bind(values)`` copies a
    linearization's primal values into the buffers (one ``_foreach_copy_``)
    and returns the product: one linearization at a time, as Newton uses
    them (a later ``bind`` redirects an earlier product).  The kernels are
    the eager program's, so the products are its bits;
    ``GraphedTangent.REPLAYS`` counts the replays."""

    REPLAYS = 0

    def __init__(self, tangent_fn, values, w):
        self.values = [v.clone() for v in values]
        self.z = torch.zeros_like(w)
        side = torch.cuda.Stream(device=w.device)
        side.wait_stream(torch.cuda.current_stream(w.device))
        with torch.cuda.stream(side):  # warm-up off the capturing stream
            for _ in range(2):
                tangent_fn(*self.values, self.z)
        torch.cuda.current_stream(w.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = tangent_fn(*self.values, self.z)

    def bind(self, values):
        torch._foreach_copy_(self.values, list(values))

        def product(z):
            self.z.copy_(z)
            self.graph.replay()
            GraphedTangent.REPLAYS += 1
            return self.out.clone()

        return product


def make_preconditioner(u, v, p, *, dx, dy, rho, mu, bc, scheme,
                        pres_cfg: MultigridConfig, su, sv, sp,
                        momentum_sweeps: int = 1, ap_shift=0.0):
    """SIMPLE-type block preconditioner frozen at the Newton iterate
    (u, v, p): ``momentum_sweeps`` Jacobi sweeps on the frozen momentum
    stencils + one multigrid pressure projection.  ``ap_shift`` adds the
    pseudo-transient rho dx dy / dtau to the momentum diagonal.  The
    multigrid hierarchy is built once here (K4 on the card where its gate
    admits it); each application is one ``multigrid_solve`` on it."""
    ub, vb = apply_velocity_bcs(u, v, bc)
    kw = dict(dx=dx, dy=dy, rho=rho, mu=mu, scheme=scheme)
    c_u = _assemble_coeffs(ub, vb, p, is_u=True, **kw)
    c_v = _assemble_coeffs(ub, vb, p, is_u=False, **kw)
    ap_u = c_u.a_p + ap_shift
    ap_v = c_v.a_p + ap_shift
    inv_ap_u = torch.where(c_u.a_p > 0, 1.0 / ap_u, torch.zeros_like(ap_u))
    inv_ap_v = torch.where(c_v.a_p > 0, 1.0 / ap_v, torch.zeros_like(ap_v))
    # d of the unrelaxed, pseudo-time-shifted system
    d_u = d_coefficient(ap_u, dy, is_u=True)
    d_v = d_coefficient(ap_v, dx, is_u=False)
    dev = u.device
    u_mask = _u_interior_mask(su, device=dev)
    v_mask = _v_interior_mask(sv, device=dev)
    levels = build_levels(d_u, d_v, pres_cfg, dx=dx, dy=dy, rho=rho, variant="consistent")

    def M(r):
        r_u, r_v, r_c = _unflatten(r, su, sv, sp)
        du = _masked(u_mask, r_u * inv_ap_u)
        dv = _masked(v_mask, r_v * inv_ap_v)
        for _ in range(momentum_sweeps - 1):
            du = _masked(u_mask, du + (r_u - _apply(du, c_u) - ap_shift * du) * inv_ap_u)
            dv = _masked(v_mask, dv + (r_v - _apply(dv, c_v) - ap_shift * dv) * inv_ap_v)
        # continuity: pressure_rhs(d grad x) = -L x, so D(du0 + d grad dp)
        # = r_c needs L dp = div(du0) - r_c
        rhs = pressure_rhs(du, dv, dx=dx, dy=dy, rho=rho, pin=False) - r_c
        rhs = rhs - torch.mean(rhs)
        dp, _ = multigrid_solve(rhs, d_u, d_v, torch.zeros(sp, dtype=rhs.dtype, device=dev),
                                pres_cfg, dx=dx, dy=dy, rho=rho, variant="consistent",
                                levels=levels)
        # velocity correction du += d grad dp (update_velocity's signs)
        grad_u = pad2(dp[:-1, :] - dp[1:, :], 1, 1)
        grad_v = pad2(dp[:, :-1] - dp[:, 1:], 0, 0, 1, 1)
        du = torch.where(u_mask, du + d_u * grad_u, du)
        dv = torch.where(v_mask, dv + d_v * grad_v, dv)
        dp = dp - torch.mean(dp)
        return _flatten(du, dv, dp)

    return M


def _build_newton_step(su, sv, sp, dx, dy, rho, mu, bc, cfg: NewtonConfig,
                       pres_cfg: MultigridConfig, device):
    """One Newton step: linearize F at w, GMRES-solve J d = -F, line-search
    the update.  Returns ``(step_fn, F, mom_norms)``; ``step_fn(w, damping,
    inv_dtau)`` returns ``(w', norm, ||F(w')||, ||F(w)||, gmres_iters,
    n_backtracks, lin_rel)``."""
    F = make_residual(dx=dx, dy=dy, rho=rho, mu=mu, bc=bc, scheme=cfg.scheme,
                      su=su, sv=sv, sp=sp)
    u_mask = _u_interior_mask(su, device=device)
    v_mask = _v_interior_mask(sv, device=device)

    def mom_norms(w):
        """max(||r_u||, ||r_v||): the SIMPLE loop's convergence norms."""
        u, v, p = _unflatten(w, su, sv, sp)
        u, v = apply_velocity_bcs(u, v, bc)
        kw = dict(dx=dx, dy=dy, rho=rho, mu=mu, scheme=cfg.scheme)
        _, un = _unrelaxed_residual(u, _assemble_coeffs(u, v, p, is_u=True, **kw), is_u=True)
        _, vn = _unrelaxed_residual(v, _assemble_coeffs(u, v, p, is_u=False, **kw), is_u=False)
        return torch.maximum(un, vn)

    def _linearized(w, inv_dtau):
        """(F(w), the shifted J z, the preconditioner M) at w."""
        key = (su, sv, sp, dx, dy, rho, mu, bc, cfg.scheme, w.dtype, w.device)
        if key not in _LINEARIZATIONS:  # traced once per residual, dtype and device
            if len(_LINEARIZATIONS) >= _KEEP_LINEARIZATIONS:
                _LINEARIZATIONS.pop(next(iter(_LINEARIZATIONS)))
            _LINEARIZATIONS[key] = split_linearization(F, w)
        Fw, jvp = _LINEARIZATIONS[key](w)

        # pseudo-transient shift rho vol / dtau on the interior momentum rows
        shift_mask = _flatten(u_mask.to(w.dtype), v_mask.to(w.dtype),
                              torch.zeros(sp, dtype=w.dtype, device=w.device))
        ap_shift = (rho * dx * dy) * inv_dtau
        shift = ap_shift * shift_mask

        def jvp_s(z):
            return jvp(z) + shift * z

        u, v, p = _unflatten(w, su, sv, sp)
        M = make_preconditioner(u, v, p, dx=dx, dy=dy, rho=rho, mu=mu, bc=bc,
                                scheme=cfg.scheme, pres_cfg=pres_cfg, su=su, sv=sv, sp=sp,
                                momentum_sweeps=cfg.momentum_sweeps, ap_shift=ap_shift)
        return Fw, jvp_s, M

    def _line_search(w, d, damping, f0):
        # PTC steps follow the implicit-Euler path, which is not ||F||
        # monotone: with PTC only blow-ups (> 25%) are backtracked
        accept = 1.25 if cfg.dtau0 > 0 else 1.0
        lam = damping
        w1 = w + lam * d
        f1 = torch.linalg.vector_norm(F(w1))
        n_bt = 0
        if cfg.max_backtracks > 0:
            while bool(f1 >= accept * f0) and n_bt < cfg.max_backtracks:
                lam = lam * 0.5
                w1 = w + lam * d
                f1 = torch.linalg.vector_norm(F(w1))
                n_bt += 1
        return w1, f1, n_bt

    def newton_step(w, damping, inv_dtau):
        Fw, jvp_s, M = _linearized(w, inv_dtau)
        d, r_lin, k = gmres_solve(-Fw, jvp_s, M, torch.zeros_like(w), cfg.gmres_tol,
                                  cfg.gmres_maxiter, cfg.gmres_restart)
        f0 = torch.linalg.vector_norm(Fw)
        lin_rel = torch.linalg.vector_norm(r_lin) / torch.clamp(f0, min=1e-30)
        w1, f1, n_bt = _line_search(w, d, damping, f0)
        return w1, mom_norms(w1), f1, f0, k, n_bt, lin_rel

    def gmres_chunk(w, d0, inv_dtau):
        """``cfg.gmres_chunk`` restart cycles of the Newton linear solve from
        d0; a restart cycle is a fresh Arnoldi from the current residual,
        so the chunks together are the monolithic solve."""
        Fw, jvp_s, M = _linearized(w, inv_dtau)
        d, r_lin, k = gmres_solve(-Fw, jvp_s, M, d0, cfg.gmres_tol,
                                  cfg.gmres_chunk * cfg.gmres_restart, cfg.gmres_restart)
        return d, torch.linalg.vector_norm(r_lin), torch.linalg.vector_norm(Fw), k

    def newton_step_chunked(w, damping, inv_dtau):
        d = torch.zeros_like(w)
        total_k = 0
        f0 = r_lin = None
        n_chunks = -(-cfg.gmres_maxiter // (cfg.gmres_chunk * cfg.gmres_restart))
        for _ in range(n_chunks):
            d, r_lin, f0, k = gmres_chunk(w, d, inv_dtau)
            total_k += int(k)
            if float(r_lin) <= cfg.gmres_tol * max(float(f0), 1e-30):
                break
        lin_rel = r_lin / torch.clamp(f0, min=1e-30)
        w1, f1, n_bt = _line_search(w, d, damping, f0)
        return w1, mom_norms(w1), f1, f0, total_k, n_bt, lin_rel

    step_fn = newton_step_chunked if cfg.gmres_chunk > 0 else newton_step
    return step_fn, F, mom_norms


def newton_solve(
    mesh: StructuredMesh,
    fluid: FluidProperties,
    bc: BoundaryConditions,
    state: FlowState,
    cfg: NewtonConfig = NewtonConfig(),
    pressure: MultigridConfig | None = None,
    verbose: bool = False,
) -> Tuple[FlowState, NewtonDiagnostics]:
    """Run Newton–Krylov from ``state`` (a SIMPLE-preconverged or
    continuation state) until ``max(||r_u||, ||r_v||) <= cfg.tolerance``,
    on the device of ``state`` (``initialize_state`` makes it on the card;
    ``device='cpu'`` there for the CPU)."""
    dx, dy = mesh.get_cell_sizes()
    rho, mu = fluid.get_density(), fluid.get_viscosity()
    pres_cfg = pressure or MultigridConfig(tolerance=1e-3, max_cycles=12, check_every=4)
    pres_cfg = dataclasses.replace(pres_cfg, max_cycles=max(pres_cfg.max_cycles,
                                                            cfg.precond_cycles))
    su, sv, sp = tuple(state.u.shape), tuple(state.v.shape), tuple(state.p.shape)
    dtype, dev = state.u.dtype, state.u.device
    newton_step, _, mom_norms = _build_newton_step(su, sv, sp, dx, dy, rho, mu, bc, cfg,
                                                   pres_cfg, dev)

    u, v = apply_velocity_bcs(state.u, state.v, bc)
    w = _flatten(u, v, state.p)
    history = [float(mom_norms(w))]
    converged = False
    total_gmres = 0
    it = 0
    dtau = cfg.dtau0
    for it in range(1, cfg.max_newton + 1):
        damping = cfg.initial_damping if it <= 2 else 1.0
        inv_dtau = torch.tensor(0.0 if dtau <= 0 else 1.0 / dtau, dtype=dtype, device=dev)
        w, norm, f1, f0, k, n_bt, lin_rel = newton_step(w, damping, inv_dtau)
        norm = float(norm)
        total_gmres += int(k)
        history.append(norm)
        if verbose:
            print(f"newton it {it}: mom_norm {norm:.3e}  ||F|| {float(f0):.3e}->"
                  f"{float(f1):.3e}  gmres {int(k)} (lin_rel {float(lin_rel):.2e})  "
                  f"dtau {dtau:.2e}  backtracks {int(n_bt)}", flush=True)
        if not math.isfinite(norm):
            break
        if norm <= cfg.tolerance:
            converged = True
            break
        # grow dtau while GMRES solves the shifted system to its forcing
        # tolerance, hold while it only makes progress, shrink on failure
        if dtau > 0:
            lr = float(lin_rel)
            if lr <= 3.0 * cfg.gmres_tol:
                dtau = min(dtau * cfg.ser_growth, cfg.dtau_max)
            elif lr > 0.5:
                dtau = max(dtau / cfg.ser_growth, cfg.dtau0 / 8)

    u, v, p = _unflatten(w, su, sv, sp)
    u, v = apply_velocity_bcs(u, v, bc)
    p = p - torch.mean(p)
    diag = NewtonDiagnostics(converged=bool(converged), iterations=it,
                             final_residual=history[-1], residual_history=tuple(history),
                             gmres_iterations=total_gmres)
    return FlowState(u=u, v=v, p=p), diag
