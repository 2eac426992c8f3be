"""The odd-grid building blocks of the PyTorch port against the JAX package.

Vertex transfers, compensated arithmetic, the masked BiCGSTAB solves (plain,
compensated and batched pair), and the plain versions of K7 (masked
BiCGSTAB), K4 (vertex Galerkin RAP), K5 (whole multigrid solve) and K3 on a
vertex hierarchy, each against the JAX function on the same seeded numpy
inputs.  The Pallas kernels run in interpret mode, as the JAX package's own
tests run them, at those tests' tolerances (``tests/test_pallas.py``).  On
CPU tensors every kernel wrapper runs its plain version (the CUDA kernels
are held to these on the card by ``chip_smoke.py``).  Last, the port's
K3/K4/K5/K6/K7 gate decisions equal the JAX package's rules.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.ops import compensated as jcomp
from naviflow_tpu.ops import transfer as jtransfer
from naviflow_tpu.ops.pallas_krylov import bicgstab_momentum_pallas as j_bicgstab
from naviflow_tpu.ops.pallas_krylov import supports_fused_bicgstab as j_gate_bicgstab
from naviflow_tpu.ops.pallas_mg import fused_mg_solve as j_mg_solve
from naviflow_tpu.ops.pallas_mg import fused_vcycle as j_vcycle
from naviflow_tpu.ops.pallas_mg import galerkin_levels_pallas as j_rap
from naviflow_tpu.ops.pallas_mg import supports_fused as j_gate_fused
from naviflow_tpu.ops.pallas_mg import supports_fused_rap as j_gate_rap
from naviflow_tpu.ops.pallas_step import supports_fused_step as j_gate_step
from naviflow_tpu.ops.powerlaw import (relax_coefficients, u_momentum_coefficients,
                                       v_momentum_coefficients)
from naviflow_tpu.solvers import momentum as jmom
from naviflow_tpu.solvers.multigrid import MultigridConfig as JMG
from naviflow_tpu.solvers.multigrid import build_levels as j_build_levels
from naviflow_tpu.algorithms.simple import SIMPLEConfig as JSIMPLE
from naviflow_tpu.solvers import KrylovMomentumConfig as JKrylov

from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops import compensated as tcomp
from naviflow_tpu_torch.ops import krylov, mg, step
from naviflow_tpu_torch.ops import transfer as ttransfer
from naviflow_tpu_torch.solvers import momentum as tmom
from naviflow_tpu_torch.solvers.multigrid import build_levels as t_build_levels

torch.set_num_threads(2)
# no TF32 anywhere a float32 product could run (none does on these paths)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_NAMES = ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")


def rel_err(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-30)


def T(x, dtype=torch.float32):
    return interop.tensor(x, dtype=dtype)


# ---------------------------------------------------------------------------
# vertex transfers and compensated arithmetic


@pytest.mark.parametrize("shape", [(31, 31), (15, 31), (7, 3)])
def test_vertex_transfers_match_jax_f64(shape):
    """ops/transfer.py in float64 to 1e-12, in float32 to 1e-6 (summation
    order is the same, so float32 agrees to rounding)."""
    rng = np.random.default_rng(11)
    nf_, mf = shape
    nc, mc = ttransfer.coarse_size(nf_), ttransfer.coarse_size(mf)
    assert (nc, mc) == (jtransfer.coarse_size(nf_), jtransfer.coarse_size(mf))
    fine = rng.normal(size=shape)
    coarse = rng.normal(size=(nc, mc))
    for jdt, tdt, tol in ((jnp.float64, torch.float64, 1e-12), (jnp.float32, torch.float32, 1e-6)):
        jf, jc = jnp.asarray(fine, jdt), jnp.asarray(coarse, jdt)
        tf, tc = T(fine, tdt), T(coarse, tdt)
        assert rel_err(ttransfer.restrict_full_weighting(tf),
                       jtransfer.restrict_full_weighting(jf)) < tol
        assert rel_err(ttransfer.restrict_inject(tf), jtransfer.restrict_inject(jf)) < tol
        assert rel_err(ttransfer.prolong_linear(tc, nf_, mf),
                       jtransfer.prolong_linear(jc, nf_, mf)) < tol


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_compensated_ops_match_jax(dtype):
    """two_sum / two_prod bit for bit; the fold reductions and the
    compensated combination to 1e-12 (float64) or 1e-6 (float32)."""
    rng = np.random.default_rng(12)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-12 if dtype == "float64" else 1e-6
    a, b, x = (rng.normal(size=(31, 29)) for _ in range(3))
    ja, jb, jx = (jnp.asarray(t, jdt) for t in (a, b, x))
    ta, tb, tx = (T(t, tdt) for t in (a, b, x))
    for tf, jf in ((tcomp.two_sum, jcomp.two_sum), (tcomp.two_prod, jcomp.two_prod)):
        for g, w in zip(tf(ta, tb), jf(ja, jb)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for tf, jf, args in ((tcomp.fold_sum, jcomp.fold_sum, (0,)),
                         (tcomp.fold_dot, jcomp.fold_dot, (0, 1)),
                         (tcomp.fold_norm2, jcomp.fold_norm2, (0,)),
                         (tcomp.compensated_norm, jcomp.compensated_norm, (0,))):
        got = tf(*[(ta, tb)[i] for i in args])
        want = jf(*[(ja, jb)[i] for i in args])
        assert abs(float(got) - float(want)) <= tol * abs(float(want)), tf.__name__
    terms_t = [tx, (ta, tb), (tb, tx), (-ta, tx)]
    terms_j = [jx, (ja, jb), (jb, jx), (-ja, jx)]
    for g, w in zip(tcomp.compensated_linear_combination(terms_t),
                    jcomp.compensated_linear_combination(terms_j)):
        assert rel_err(g, w) < tol


# ---------------------------------------------------------------------------
# masked BiCGSTAB (the plain version of K7, and the batched pair)


def _momentum_systems(nx, dtype, seed=3):
    """Relaxed u and v systems from a random 0.1-scale state, as the JAX
    K7 test makes them."""
    rng = np.random.default_rng(seed)
    u = jnp.asarray(rng.standard_normal((nx + 1, nx)) * 0.1, dtype)
    v = jnp.asarray(rng.standard_normal((nx, nx + 1)) * 0.1, dtype)
    p = jnp.asarray(rng.standard_normal((nx, nx)) * 0.1, dtype)
    kw = dict(dx=1 / (nx - 1), dy=1 / (nx - 1), rho=1.0, mu=0.01)
    cu = relax_coefficients(u_momentum_coefficients(u, v, p, **kw), u, 0.7)
    cv = relax_coefficients(v_momentum_coefficients(u, v, p, **kw), v, 0.7)
    return u, cu, v, cv


@pytest.mark.parametrize("compensated", [False, True])
def test_bicgstab_masked_matches_jax_f64(compensated):
    """_bicgstab_masked at 31^2 in float64, plain and compensated dots, to
    1e-10 of the field."""
    u, cu, v, cv = _momentum_systems(31, jnp.float64)
    for x0, c, mask in ((u, cu, jmom._u_interior_mask(u.shape)),
                        (v, cv, jmom._v_interior_mask(v.shape))):
        for maxiter in (3, 25):
            want = jmom._bicgstab_masked(x0, c, mask, 1e-8, maxiter,
                                         compensated_dots=compensated)
            got = tmom._bicgstab_masked(T(x0, torch.float64),
                                        interop.stencil_coeffs(c, dtype=torch.float64),
                                        T(mask, torch.bool), 1e-8, maxiter,
                                        compensated_dots=compensated)
            assert rel_err(got, want) < 1e-10, (maxiter, rel_err(got, want))


def test_bicgstab_pair_masked_matches_jax_f64():
    """_bicgstab_pair_masked (the batched u+v loop) at 31^2 in float64."""
    u, cu, v, cv = _momentum_systems(31, jnp.float64, seed=4)
    mu_, mv_ = jmom._u_interior_mask(u.shape), jmom._v_interior_mask(v.shape)
    for maxiter in (3, 25):
        wu, wv = jmom._bicgstab_pair_masked(u, cu, mu_, v, cv, mv_, 1e-8, maxiter)
        f64 = torch.float64
        gu, gv = tmom._bicgstab_pair_masked(
            T(u, f64), interop.stencil_coeffs(cu, dtype=f64), T(mu_, torch.bool),
            T(v, f64), interop.stencil_coeffs(cv, dtype=f64), T(mv_, torch.bool), 1e-8, maxiter)
        assert rel_err(gu, wu) < 1e-10 and rel_err(gv, wv) < 1e-10, maxiter


def test_krylov_pair_gate_and_compensated_residual_match_jax():
    """The port takes the batched pair where the JAX package does on the CPU
    (and not with compensated dots or backend='composed'), and the
    compensated unrelaxed residual agrees with JAX's in float64."""
    cfg = JKrylov(tolerance=1e-6, max_iterations=20)
    for jc in (cfg, dataclasses.replace(cfg, compensated_dots=True),
               dataclasses.replace(cfg, batch_pair="off"),
               dataclasses.replace(cfg, backend="xla")):
        want = jmom._pair_krylov_applicable(jc, (32, 31), (31, 32), jnp.float32, "power_law",
                                             None)
        got = tmom._pair_krylov_applicable(interop.config(jc), (32, 31), (31, 32),
                                           torch.float32, "power_law", torch.device("cpu"))
        assert got == want, jc
    u, cu_rel, v, _ = _momentum_systems(31, jnp.float64, seed=5)
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=u.shape), jnp.float64)
    for comp in (False, True):
        wr, wn = jmom._unrelaxed_residual(x, cu_rel, is_u=True, compensated=comp)
        gr, gn = tmom._unrelaxed_residual(T(x, torch.float64),
                                          interop.stencil_coeffs(cu_rel, dtype=torch.float64),
                                          is_u=True, compensated=comp)
        assert rel_err(gr, wr) < 1e-12 and abs(float(gn) - float(wn)) <= 1e-12 * float(wn)


def test_k7_plain_matches_pallas_kernel():
    """K7 (ops/krylov.bicgstab_momentum) at 31^2, maxiter 3 and 25: 1e-4 of
    the field (tests/test_pallas.py's K7 tolerance)."""
    u, cu, v, cv = _momentum_systems(31, jnp.float32)
    for x0, c in ((u, cu), (v, cv)):
        for maxiter in (3, 25):
            want = j_bicgstab(x0, c, tol=1e-8, maxiter=maxiter, interpret=True)
            got = krylov.bicgstab_momentum(T(x0), interop.stencil_coeffs(c, dtype=torch.float32),
                                           tol=1e-8, maxiter=maxiter)
            assert rel_err(got, want) < 1e-4, (maxiter, rel_err(got, want))
    assert krylov.LAUNCHES == 0  # CPU tensors never launch


# ---------------------------------------------------------------------------
# the vertex multigrid kernels


def _mg_system(nx, seed=5):
    rng = np.random.default_rng(seed)
    d_u = jnp.asarray((rng.random((nx + 1, nx)) + 0.5).astype(np.float32))
    d_v = jnp.asarray((rng.random((nx, nx + 1)) + 0.5).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(nx, nx)).astype(np.float32))
    b = b - jnp.mean(b)
    dx = dy = 1.0 / (nx - 1)
    return d_u, d_v, b, dx, dy


def _both_levels(nx, jcfg):
    d_u, d_v, b, dx, dy = _mg_system(nx)
    jlev = j_build_levels(d_u, d_v, jcfg, dx=dx, dy=dy, rho=1.0, variant="consistent")
    tlev = t_build_levels(T(d_u), T(d_v), interop.config(jcfg), dx=dx, dy=dy, rho=1.0,
                          variant="consistent")
    return jlev, tlev, b


def test_k4_plain_matches_pallas_kernel():
    """K4 (ops/mg.galerkin_levels) at 31^2: every coarse stencil entry to
    1e-5 of its array (tests/test_pallas.py's K4 tolerance); the port's
    composed hierarchy matches the JAX one too."""
    jlev, tlev, _ = _both_levels(31, JMG())
    shapes = [lv[1] for lv in jlev]
    assert [lv[1] for lv in tlev] == shapes == [(31, 31), (15, 15), (7, 7)]
    want = j_rap(jlev[0][0], shapes, True, interpret=True)
    got = mg.galerkin_levels(tlev[0][0], shapes, True)
    for g, w, (tst, _, _, _) in zip(got, want, tlev[1:]):
        for name in _NAMES:
            assert rel_err(getattr(g, name), getattr(w, name)) < 1e-5, name
            assert rel_err(getattr(tst, name), getattr(w, name)) < 1e-5, name
    assert mg.RAP_LAUNCHES == 0


def test_k5_plain_matches_pallas_kernel():
    """K5 (ops/mg.fused_mg_solve) at 31^2 (tests/test_pallas.py's K5 case):
    cycle counts equal, p within 1e-4, rel within 1e-5."""
    jcfg = JMG(tolerance=1e-4, max_cycles=30, check_every=2, coarsest_sweeps=16)
    jlev, tlev, b = _both_levels(31, jcfg)
    p0 = jnp.zeros(b.shape, jnp.float32)
    wp, wr, wcyc, wrel = j_mg_solve(p0, b, jlev, jcfg, interpret=True)
    gp, gr, gcyc, grel = mg.fused_mg_solve(torch.zeros(b.shape), T(b), tlev,
                                           interop.config(jcfg))
    assert int(gcyc) == int(wcyc)
    assert rel_err(gp, wp) < 1e-4
    assert rel_err(gr, wr) < 1e-3
    assert abs(float(grel) - float(wrel)) < 1e-5
    assert mg.SOLVE_LAUNCHES == 0


def test_k3_plain_matches_pallas_kernel_on_vertex_hierarchy():
    """K3 (ops/mg.fused_vcycle) on the 31^2 -> 7^2 vertex hierarchy, two
    chained cycles, 1e-5 of the cycle output's scale."""
    jcfg = JMG(coarsest_sweeps=16)
    jlev, tlev, b = _both_levels(31, jcfg)
    assert mg.supports_fused(tlev, interop.config(jcfg))
    jp, tp = jnp.zeros(b.shape, jnp.float32), torch.zeros(b.shape)
    for _ in range(2):
        jp = j_vcycle(jp, b, jlev, jcfg, interpret=True)
        tp = mg.fused_vcycle(tp, T(b), tlev, interop.config(jcfg))
        assert rel_err(tp, jp) < 1e-5


# ---------------------------------------------------------------------------
# gates


def test_kernel_gates_match_jax_rules():
    """K7, K4, K3/K5 and K6 admit exactly what the JAX rules admit."""
    f32 = (jnp.float32, torch.float32)
    f64 = (jnp.float64, torch.float64)
    for shape in ((32, 31), (64, 63), (256, 255), (512, 511), (513, 512), (1024, 1023)):
        for jdt, tdt in (f32, f64):
            assert krylov.supports_fused_bicgstab(shape, tdt) == j_gate_bicgstab(shape, jdt)
    mgs = [JMG(), JMG(restriction="inject"), JMG(prolongation="cubic", coarsening="rediscretize"),
           JMG(cycle_type="fmg"), JMG(cycle_type="w"), JMG(smoother="jacobi"),
           JMG(coarsest_grid_size=3)]
    for n in (7, 31, 63, 255, 511, 64, 1023):
        for jc in mgs:
            tc = interop.config(jc)
            for jdt, tdt in (f32, f64):
                assert mg.supports_fused_rap(n, n, tc, tdt) == j_gate_rap(n, n, jc, jdt)
            assert (mg.supports_fused_rap(n, n - 2, tc, torch.float32)
                    == j_gate_rap(n, n - 2, jc, jnp.float32))
    # K3/K5 on real vertex hierarchies (the hierarchy's shapes and dtype)
    for nx in (15, 31):
        jlev, tlev, _ = _both_levels(nx, JMG())
        for jc in mgs[:2] + mgs[3:]:
            assert mg.supports_fused(tlev, interop.config(jc)) == j_gate_fused(jlev, jc)
    sc = JSIMPLE()
    moms = [JKrylov(tolerance=1e-6, max_iterations=20), JKrylov(scheme="quick"),
            nf.solvers.JacobiMomentumConfig()]
    pres = [JMG(tolerance=1e-2, max_cycles=6, check_every=2, coarsest_sweeps=8,
                coarse_rebuild_every=8), JMG(cycle_type="fmg"), JMG(smoother="jacobi"),
            nf.solvers.RBGSPressureConfig()]
    for n in (31, 63, 127, 255, 511):
        for jm in moms:
            for jp in pres:
                tm = interop.config(jm)
                tp = interop.config(jp)
                for algo in ("simple", "simplec", "piso", "simpler"):
                    want = j_gate_step(n, n, sc, jm, jp, jnp.float32, algo=algo)
                    got = step.supports_fused_step(n, n, interop.config(sc), tm, tp,
                                                   torch.float32, algo=algo)
                    assert got == want, (n, jm, jp, algo)
    assert step.supports_fused_step(63, 63, interop.config(sc), interop.config(moms[0]),
                                    interop.config(pres[0]), torch.float32)
    assert not step.supports_fused_step(511, 511, interop.config(sc), interop.config(moms[0]),
                                        interop.config(pres[0]), torch.float32)
