"""The port's multigrid variants against the JAX package on the CPU: the
damped-Jacobi and Chebyshev smoothers, the spectral estimates, cubic
prolongation with rediscretized coarsening, injection restriction,
``restrict_d_coefficients`` and ``prolong_cubic`` (the bfloat16 smoother:
``tests/test_torch_mg_bf16.py``, a file of its own so that the test
workers share the long runs).  Inputs come from numpy seeds (float64
unless stated); configs cross over through ``interop.config``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naviflow_tpu.ops import stencil9 as jst9
from naviflow_tpu.ops import transfer as jtransfer
from naviflow_tpu.solvers import chebyshev as jcheb
from naviflow_tpu.solvers import multigrid as jmg
from naviflow_tpu.solvers.multigrid import MultigridConfig as JMG

from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops import stencil9 as tst9
from naviflow_tpu_torch.ops import transfer as ttransfer
from naviflow_tpu_torch.solvers import chebyshev as tcheb
from naviflow_tpu_torch.solvers import multigrid as tmg

torch.set_num_threads(2)

_NAMES = ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")


def T(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def rel_err(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-300)


def system(n, seed=4):
    """Smooth positive d-fields and a compatible seeded RHS (zero at the
    corner cells, zero mean elsewhere) on an n^2 grid."""
    rng = np.random.default_rng(seed)
    dx = dy = 1.0 / n
    x = np.linspace(0, 1, n + 1)[:, None]
    y = np.linspace(0, 1, n)[None, :]
    d_u = (0.6 + 0.3 * np.sin(2 * np.pi * x) * np.cos(np.pi * y)) * dy
    d_v = (0.6 + 0.3 * np.cos(np.pi * y.T) * np.sin(2 * np.pi * x.T)) * dx
    b = rng.normal(size=(n, n))
    for i in (0, -1):
        for j in (0, -1):
            b[i, j] = 0.0
    b -= b.sum() / (n * n - 4)
    for i in (0, -1):
        for j in (0, -1):
            b[i, j] = 0.0
    return b, d_u, d_v, dx, dy


def both_levels(n, jcfg, dtype=(jnp.float64, torch.float64)):
    b, d_u, d_v, dx, dy = system(n)
    kw = dict(dx=dx, dy=dy, rho=1.0, variant="consistent")
    jl = jmg.build_levels(jnp.asarray(d_u, dtype[0]), jnp.asarray(d_v, dtype[0]), jcfg, **kw)
    tl = tmg.build_levels(T(d_u, dtype[1]), T(d_v, dtype[1]), interop.config(jcfg), **kw)
    return jl, tl, (b, d_u, d_v, dx, dy)


def both_solves(n, jcfg, *, lam_from_jax=False):
    """multigrid_solve in both packages; with ``lam_from_jax`` the port's
    levels carry the JAX package's lam_max (the estimates' start vectors
    differ between the packages)."""
    jl, tl, (b, d_u, d_v, dx, dy) = both_levels(n, jcfg)
    if lam_from_jax:
        tl = [lvl[:3] + (T(jlvl[3]),) for lvl, jlvl in zip(tl, jl)]
    kw = dict(dx=dx, dy=dy, rho=1.0, variant="consistent")
    pj, ij = jmg.multigrid_solve(jnp.asarray(b), jnp.asarray(d_u), jnp.asarray(d_v),
                                 jnp.zeros((n, n)), jcfg, levels=jl, **kw)
    pt, it = tmg.multigrid_solve(T(b), T(d_u), T(d_v), torch.zeros((n, n), dtype=torch.float64),
                                 interop.config(jcfg), levels=tl, **kw)
    return (pj, ij), (pt, it)


# ---------------------------------------------------------------------------
# transfers


@pytest.mark.parametrize("shape", [(7, 7), (15, 7), (3, 3), (2, 5)])
def test_prolong_cubic_matches_jax(shape):
    """prolong_cubic in float64 to 1e-14 (the same operations in the same
    order), including the linear fallback below four coarse points."""
    c = np.random.default_rng(1).normal(size=shape)
    mx, my = 2 * shape[0] + 1, 2 * shape[1] + 1
    want = jtransfer.prolong_cubic(jnp.asarray(c), mx, my)
    got = ttransfer.prolong_cubic(T(c), mx, my)
    assert rel_err(got, want) < 1e-14


@pytest.mark.parametrize("n", [31, 15, 7])
def test_restrict_d_coefficients_matches_jax(n):
    """The harmonic-mean d restriction (with sign changes, so the
    arithmetic fallback runs too), exactly."""
    rng = np.random.default_rng(n)
    d_u = rng.uniform(-0.2, 1.5, (n + 1, n))
    d_v = rng.uniform(-0.2, 1.5, (n, n + 1))
    ju, jv = jtransfer.restrict_d_coefficients(jnp.asarray(d_u), jnp.asarray(d_v))
    tu, tv = ttransfer.restrict_d_coefficients(T(d_u), T(d_v))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# levels and cycles


def test_rediscretize_levels_match_jax():
    """coarsening='rediscretize': the same ladder of 5-point levels, every
    stencil array to 1e-14."""
    cfg = JMG(coarsening="rediscretize", prolongation="cubic")
    jl, tl, _ = both_levels(31, cfg)
    assert [(lv[1], lv[2]) for lv in tl] == [(tuple(lv[1]), lv[2]) for lv in jl]
    assert len(tl) == 3 and all(lv[2] for lv in tl)
    for (jst, *_), (tst, *_) in zip(jl, tl):
        for name in _NAMES:
            np.testing.assert_allclose(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)),
                                       rtol=1e-14, atol=1e-300)


CYCLE_CONFIGS = {
    "cubic_rediscretize": JMG(tolerance=1e-8, max_cycles=80, prolongation="cubic",
                              coarsening="rediscretize"),
    "linear_rediscretize": JMG(tolerance=1e-8, max_cycles=80, coarsening="rediscretize"),
    "inject": JMG(tolerance=1e-8, max_cycles=80, restriction="inject"),
    "jacobi": JMG(tolerance=1e-8, max_cycles=80, smoother="jacobi", omega=0.8),
    "jacobi_w": JMG(tolerance=1e-8, max_cycles=80, smoother="jacobi", cycle_type="w"),
}


# the transfer variants act on vertex (odd) grids only; the smoothers on both
VARIANT_CASES = [(name, 31) for name in CYCLE_CONFIGS] + [("jacobi", 32), ("jacobi_w", 32)]


@pytest.mark.parametrize("name,n", VARIANT_CASES)
def test_variant_solves_match_jax(name, n):
    """Each variant's solve: cycles equal, p and rel_residual to 1e-10."""
    cfg = CYCLE_CONFIGS[name]
    (pj, ij), (pt, it) = both_solves(n, cfg)
    assert it.iterations == int(ij.iterations)
    assert rel_err(pt, pj) < 1e-10
    assert abs(float(it.rel_residual) - float(ij.rel_residual)) < 1e-10


def test_cubic_requires_rediscretize():
    """cubic prolongation with Galerkin coarsening raises, as in JAX."""
    _, d_u, d_v, dx, dy = system(15)
    with pytest.raises(ValueError, match="rediscretize"):
        tmg.build_levels(T(d_u), T(d_v), tmg.MultigridConfig(prolongation="cubic"),
                         dx=dx, dy=dy, rho=1.0, variant="consistent")


# ---------------------------------------------------------------------------
# Chebyshev


@pytest.mark.parametrize("n", [31, 32])
def test_chebyshev_levels_and_solve_match_jax(n):
    """The Chebyshev smoother: each level's lam_max within 5% of the JAX
    package's (the power iterations start from different seeded vectors,
    and 25 steps leave each estimate a few percent below lam_max);
    with the JAX package's lam_max, the solve's cycles equal and p to
    1e-10."""
    cfg = JMG(tolerance=1e-8, max_cycles=80, smoother="chebyshev", cheby_degree=4)
    jl, tl, _ = both_levels(n, cfg)
    for jlv, tlv in zip(jl, tl):
        assert abs(float(tlv[3]) / float(jlv[3]) - 1.0) < 0.05, tlv[1]
    (pj, ij), (pt, it) = both_solves(n, cfg, lam_from_jax=True)
    assert it.iterations == int(ij.iterations)
    assert rel_err(pt, pj) < 1e-10


@pytest.mark.parametrize("degree", [2, 4, 7])
def test_chebyshev_smooth_matches_jax(degree):
    """chebyshev_smooth on a 9-point level at the JAX package's lam_max, to
    1e-12 (float64)."""
    jl, tl, _ = both_levels(31, JMG())
    rng = np.random.default_rng(degree)
    jst, (nx, ny), _, _ = jl[1]
    tst = tl[1][0]
    p = rng.normal(size=(nx, ny))
    b = rng.normal(size=(nx, ny))
    lam = jcheb.estimate_lambda_max(jst, (nx, ny))
    want = jcheb.chebyshev_smooth(jnp.asarray(p), jnp.asarray(b), jst, lam, degree=degree)
    got = tcheb.chebyshev_smooth(T(p), T(b), tst, T(lam), degree=degree)
    assert rel_err(got, want) < 1e-12


def test_spectral_estimates_match_jax():
    """estimate_lambda_max and estimate_smoother_spectral_radius within 5%
    of the JAX package's, optimal_jacobi_omega exactly, on a 5-point and a
    9-point level; the 5-point Laplacian's lam_max tends to 2."""
    jl, tl, _ = both_levels(31, JMG())
    for (jst, shp, *_), (tst, *_) in zip(jl[:2], tl[:2]):
        jlam = float(jcheb.estimate_lambda_max(jst, shp))
        tlam = float(tcheb.estimate_lambda_max(tst, shp))
        assert abs(tlam / jlam - 1.0) < 0.05, (shp, tlam, jlam)
        assert tcheb.optimal_jacobi_omega(tlam) == 2.0 / tlam
        jrho = float(jcheb.estimate_smoother_spectral_radius(jst, shp, 2.0 / 3.0))
        trho = float(tcheb.estimate_smoother_spectral_radius(tst, shp, 2.0 / 3.0))
        assert abs(trho / jrho - 1.0) < 0.05 and trho < 1.0
    ones = torch.ones((34, 33), dtype=torch.float64)
    from naviflow_tpu_torch.ops.poisson import poisson_coefficients

    c = poisson_coefficients(ones, ones.T.contiguous(), dx=1.0, dy=1.0, rho=1.0,
                             variant="symmetric")
    lam = float(tcheb.estimate_lambda_max(tst9.from_poisson(c), (33, 33), iterations=80))
    assert 1.8 < lam <= 2.01


def test_jacobi9_sweep_matches_jax():
    jl, tl, _ = both_levels(15, JMG())
    rng = np.random.default_rng(3)
    jst, shp, _, _ = jl[1]
    p, b = rng.normal(size=shp), rng.normal(size=shp)
    want = jst9.jacobi9_sweep(jnp.asarray(p), jnp.asarray(b), jst, 0.7)
    got = tst9.jacobi9_sweep(T(p), T(b), tl[1][0], 0.7)
    assert rel_err(got, want) < 1e-14
