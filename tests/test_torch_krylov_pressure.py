"""The port's pressure-solver zoo against the JAX package on the CPU (f64):
CG, BiCGSTAB and GMRES with and without Jacobi preconditioning, MGCG, the
breakdown guard of the flexible CG, weighted-Jacobi and direct pressure,
and the dense pressure matrix entry by entry (one SIMPLE solve per new
pressure kind: ``tests/test_torch_krylov_pressure_simple.py``, a file of its
own so that the test workers share the long runs).  Inputs come from numpy
seeds; configs cross over through ``interop.config``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naviflow_tpu.ops.poisson import poisson_coefficients as j_coeffs
from naviflow_tpu.solvers import krylov as jk
from naviflow_tpu.solvers import pressure as jp
from naviflow_tpu.solvers.multigrid import MultigridConfig as JMG

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops.poisson import poisson_coefficients as t_coeffs
from naviflow_tpu_torch.solvers import dispatch
from naviflow_tpu_torch.solvers import krylov as tk
from naviflow_tpu_torch.solvers import pressure as tp

torch.set_num_threads(2)


def T(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def rel_err(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))


def system(n, seed=3, variant="consistent"):
    """Smooth positive d-fields and a seeded RHS compatible with the
    consistent operator's nullspace (zero at the corner cells, zero mean
    elsewhere); the JAX and the port's Poisson coefficients of them."""
    rng = np.random.default_rng(seed)
    dx = dy = 1.0 / n
    x = np.linspace(0, 1, n + 1)[:, None]
    y = np.linspace(0, 1, n)[None, :]
    d_u = (0.6 + 0.3 * np.sin(2 * np.pi * x) * np.cos(np.pi * y)) * dy
    d_v = (0.6 + 0.3 * np.cos(np.pi * y.T) * np.sin(2 * np.pi * x.T)) * dx
    b = rng.normal(size=(n, n))
    corners = (0, -1)
    for i in corners:
        for j in corners:
            b[i, j] = 0.0
    b -= b.sum() / (n * n - 4)
    for i in corners:
        for j in corners:
            b[i, j] = 0.0
    kw = dict(dx=dx, dy=dy, rho=1.0, variant=variant)
    jc = j_coeffs(jnp.asarray(d_u), jnp.asarray(d_v), **kw)
    tc = t_coeffs(T(d_u), T(d_v), **kw)
    return dict(b=b, d_u=d_u, d_v=d_v, dx=dx, dy=dy, jc=jc, tc=tc, variant=variant)


def both_krylov(s, cfg):
    n = s["b"].shape[0]
    kw = dict(dx=s["dx"], dy=s["dy"], rho=1.0, variant=s["variant"])
    xj, ij = jk.solve_pressure_krylov(jnp.asarray(s["b"]), s["jc"], jnp.zeros((n, n)), cfg,
                                      d_u=jnp.asarray(s["d_u"]), d_v=jnp.asarray(s["d_v"]),
                                      **kw)
    xt, it = tk.solve_pressure_krylov(T(s["b"]), s["tc"], torch.zeros((n, n),
                                                                      dtype=torch.float64),
                                      interop.config(cfg), d_u=T(s["d_u"]), d_v=T(s["d_v"]),
                                      **kw)
    return (xj, ij), (xt, it)


# BiCGSTAB's trajectory amplifies rounding on these systems (the JAX package
# against itself with b perturbed by 1e-15 drifts 3e-10 after 20
# iterations), so it is held where it stops within ~11 iterations.  The
# unpinned 'reference' operator is nonsingular, where CG and GMRES agree
# to ~1e-15 all the way to 1e-8.
KRYLOV_CASES = [(kind, pre, n) for kind, pre in (("cg", "jacobi"), ("cg", "none"),
                                                   ("bicgstab", "jacobi"), ("bicgstab", "none"),
                                                   ("gmres", "jacobi"), ("gmres", "none"))
                for n in (32, 31)]


@pytest.mark.parametrize("kind,pre,n", KRYLOV_CASES)
def test_krylov_matches_jax(kind, pre, n):
    """Each Krylov kind x preconditioner: iterations equal, x and
    rel_residual to 1e-10."""
    s = system(n, variant="reference")
    cls = {"cg": jk.CGPressureConfig, "bicgstab": jk.BiCGSTABPressureConfig,
           "gmres": jk.GMRESPressureConfig}[kind]
    tol = 3e-2 if kind == "bicgstab" else 1e-8
    cfg = cls(tolerance=tol, max_iterations=600, preconditioner=pre)
    (xj, ij), (xt, it) = both_krylov(s, cfg)
    assert it.iterations == int(ij.iterations) > 0
    assert float(it.rel_residual) <= tol
    assert rel_err(xt, xj) < 1e-10
    assert abs(float(it.rel_residual) - float(ij.rel_residual)) < 1e-10
    # the residual of a converged x is a difference of near-equal terms:
    # held against the scale of b
    gap = np.abs(it.residual_field.numpy() - np.asarray(ij.residual_field)).max()
    assert gap < 1e-12 * np.abs(s["b"]).max()


@pytest.mark.parametrize("n", [32, 31])
def test_mgcg_matches_jax(n):
    """MGCG (one V-cycle preconditioner, cell-centred at 32^2, vertex at
    31^2) on the consistent operator: iterations equal, x and rel_residual
    to 1e-10; the consistent CG and GMRES with Jacobi agree as closely."""
    s = system(n)
    for cfg in (jk.MGCGPressureConfig(tolerance=1e-8, max_iterations=100),
                jk.CGPressureConfig(tolerance=1e-8, max_iterations=600),
                jk.GMRESPressureConfig(tolerance=1e-8, max_iterations=600)):
        (xj, ij), (xt, it) = both_krylov(s, cfg)
        assert it.iterations == int(ij.iterations) > 0, cfg
        assert float(it.rel_residual) <= 1e-8
        assert rel_err(xt, xj) < 1e-10, cfg
        assert abs(float(it.rel_residual) - float(ij.rel_residual)) < 1e-10


@pytest.mark.parametrize("curvature", [0.0, -1.0])
def test_pcg_breakdown_guard(curvature):
    """A zero or negative curvature takes no step and ends CG after one
    iteration, in both packages."""
    rng = np.random.default_rng(5)
    b = rng.normal(size=(8, 8))
    x0 = rng.normal(size=(8, 8))
    xj, rj, kj = jk._pcg(jnp.asarray(b), lambda x: curvature * x, lambda r: r,
                         jnp.asarray(x0), 1e-10, 50)
    xt, rt, kt = tk._pcg(T(b), lambda x: curvature * x, lambda r: r, T(x0), 1e-10, 50)
    assert kt == int(kj) == 1
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-15)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-15)
    # no step: x is the zero-mean start
    np.testing.assert_allclose(xt.numpy(), x0 - x0.mean(), rtol=0, atol=1e-15)


@pytest.mark.parametrize("variant,pin", [("consistent", False), ("reference", True)])
def test_jacobi_pressure_matches_jax(variant, pin):
    """Weighted Jacobi to 1e-6 (checked every 3 sweeps): sweeps equal, p
    to 1e-10."""
    s = system(16, variant=variant)
    b = s["b"] if not pin else np.where(np.arange(16)[:, None] + np.arange(16) == 0, 0.0,
                                        s["b"])
    cfg = jp.JacobiPressureConfig(tolerance=1e-6, max_iterations=20000, check_every=3)
    pj, ij = jp.solve_pressure(jnp.asarray(b), s["jc"], jnp.zeros((16, 16)), cfg, pin=pin)
    pt, it = tp.solve_pressure(T(b), s["tc"], torch.zeros((16, 16), dtype=torch.float64),
                               interop.config(cfg), pin=pin)
    assert it.iterations == int(ij.iterations) > 3
    assert rel_err(pt, pj) < 1e-10
    # one sweep by itself
    p0 = np.random.default_rng(2).normal(size=(16, 16))
    want = jp.jacobi_sweep(jnp.asarray(p0), jnp.asarray(b), s["jc"], 0.8, pin=pin)
    got = tp.jacobi_sweep(T(p0), T(b), s["tc"], 0.8, pin=pin)
    assert rel_err(got, want) < 1e-14


@pytest.mark.parametrize("shape", [(5, 7), (6, 6)])
@pytest.mark.parametrize("pin", [False, True])
def test_dense_poisson_matrix_entries(shape, pin):
    """The dense matrix entry by entry (Fortran numbering, the floored
    empty rows, the ones/n shift or the identity row 0)."""
    rng = np.random.default_rng(7)
    nx, ny = shape
    d_u = rng.uniform(0.5, 1.5, (nx + 1, ny))
    d_v = rng.uniform(0.5, 1.5, (nx, ny + 1))
    variant = "reference" if pin else "consistent"
    jc = j_coeffs(jnp.asarray(d_u), jnp.asarray(d_v), dx=0.3, dy=0.2, rho=1.0, variant=variant)
    tc = t_coeffs(T(d_u), T(d_v), dx=0.3, dy=0.2, rho=1.0, variant=variant)
    want = np.asarray(jp.dense_poisson_matrix(jc, pin=pin))
    got = tp.dense_poisson_matrix(tc, pin=pin).numpy()
    assert got.shape == want.shape == (nx * ny, nx * ny)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,variant,pin", [(16, "consistent", False), (15, "reference", True)])
def test_direct_pressure_matches_jax(n, variant, pin):
    """The dense solve: p to 1e-10, the residual at rounding level."""
    s = system(n, variant=variant)
    pj, ij = jp.solve_pressure(jnp.asarray(s["b"]), s["jc"], jnp.zeros((n, n)),
                               jp.DirectPressureConfig(), pin=pin)
    pt, it = tp.solve_pressure(T(s["b"]), s["tc"], torch.zeros((n, n), dtype=torch.float64),
                               tp.DirectPressureConfig(), pin=pin)
    assert it.iterations == int(ij.iterations) == 1
    assert rel_err(pt, pj) < 1e-10
    assert float(it.rel_residual) < 1e-10


def test_dispatch_routes_every_pressure_kind():
    """Every pressure config type of the JAX package's dispatch has its
    counterpart, and the port's dispatch routes each."""
    from naviflow_tpu.solvers import dispatch as jdispatch

    assert ([c.__name__ for c in dispatch.PRESSURE_CONFIG_TYPES]
            == [c.__name__ for c in jdispatch.PRESSURE_CONFIG_TYPES])
    s = system(8)
    for cls in dispatch.PRESSURE_CONFIG_TYPES:
        cfg = cls()
        p, info = dispatch.dispatch_pressure_solve(
            T(s["b"]), s["tc"], torch.zeros((8, 8), dtype=torch.float64), cfg,
            d_u=T(s["d_u"]), d_v=T(s["d_v"]), dx=s["dx"], dy=s["dy"], rho=1.0,
            variant="consistent", pin=False)
        assert p.shape == (8, 8) and bool(torch.isfinite(p).all()), cls.__name__
    mgcg = interop.config(jk.MGCGPressureConfig(mg=JMG(backend="xla", pre_smoothing=1)))
    assert isinstance(mgcg.mg, nt.solvers.MultigridConfig)
    assert mgcg.mg.backend == "composed" and mgcg.mg.pre_smoothing == 1
