"""The Krylov and stationary loops written through the port's
``lax.while_loop`` (``ops/while_loop.py``), on the CPU in float64.

``solvers/krylov.py``'s ``_pcg`` (CG with Jacobi, MGCG), ``_bicgstab`` and
``gmres_solve`` (through ``solve_pressure_krylov``), ``solvers/pressure.py``'s
``_iterate`` (Jacobi and red-black GS, through ``solve_pressure``), and
``solvers/momentum.py``'s ``_gmres_masked`` and ``_idrs_masked``, on three
seeded cases each:

* one case at a time against the JAX function (its ``lax.while_loop``) to
  rel 1e-12 (iterates; ``rel_residual``, already relative to ||b||, within
  1e-12), iteration counts equal;
* under ``torch.func.vmap`` over the three cases, with every warning an
  error (an operator without a batching rule falls back to a per-case loop
  with a warning): each case's count its single call's, the counts not all
  equal, and each case bit-equal to its single call (the loops' dots,
  norms, means and GMRES's least squares run case by case under ``vmap``,
  ``while_loop.case_by_case``; a batched ``torch.dot`` rounds apart);
* ``case_by_case`` itself: each case bit-equal to its single call,
  operands shared or batched on any axis, a misaligned case copied.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
import naviflow_tpu.solvers.momentum as jmom
from naviflow_tpu.ops.poisson import poisson_coefficients as j_coeffs
from naviflow_tpu.ops.powerlaw import relax_coefficients, u_momentum_coefficients
from naviflow_tpu.solvers import krylov as jk
from naviflow_tpu.solvers import pressure as jp

from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops.poisson import poisson_coefficients as t_coeffs
from naviflow_tpu_torch.ops.stencil import StencilCoeffs, interior_mask
from naviflow_tpu_torch.solvers import krylov as tk
from naviflow_tpu_torch.solvers import momentum as tmom
from naviflow_tpu_torch.solvers import pressure as tp

torch.set_num_threads(2)

N = 24
KW = dict(dx=1.0 / N, dy=1.0 / N, rho=1.0, variant="consistent")
FIELDS = ("a_e", "a_w", "a_n", "a_s", "a_p", "src")


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-300)


def _T(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _vmapped(fn, *args):
    """``torch.func.vmap(fn)(*args)`` with every warning an error."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return torch.func.vmap(fn)(*args)


def _pressure_cases(seed=7):
    """Three seeded positive d-field pairs, each rougher than the last, and
    right-hand sides the consistent operator admits (zero at the four
    corner cells, which have no face link, zero mean elsewhere); numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(3):
        d_u = (rng.random((N + 1, N)) * (1 + 8 * k) + 0.5) / N
        d_v = (rng.random((N, N + 1)) * (1 + 8 * k) + 0.5) / N
        b = rng.normal(size=(N, N))
        corners = np.zeros((N, N), dtype=bool)
        corners[[0, 0, -1, -1], [0, -1, 0, -1]] = True
        b[corners] = 0.0
        b[~corners] -= b[~corners].mean()
        out.append((b, d_u, d_v))
    return out


# the command line's constructors at tolerances where each loop runs a
# dozen or more iterations (BiCGSTAB, whose trajectory amplifies rounding,
# where it stops within a dozen against the JAX solve, as in
# test_torch_krylov_pressure.py)
PRESSURE = {
    "cg": jk.CGPressureConfig(tolerance=1e-8, max_iterations=400),
    "mgcg": jk.MGCGPressureConfig(tolerance=1e-8, max_iterations=100),
    "bicgstab": jk.BiCGSTABPressureConfig(tolerance=5e-2, max_iterations=400),
    "gmres": jk.GMRESPressureConfig(tolerance=1e-8, max_iterations=400, restart=10),
    "jacobi": jp.JacobiPressureConfig(tolerance=1e-3, max_iterations=5000),
    "rbgs": jp.RBGSPressureConfig(tolerance=1e-6, max_iterations=5000),
}


@pytest.mark.parametrize("kind", list(PRESSURE))
def test_pressure_loop(kind):
    """A pressure loop: each case against the JAX solve (rel 1e-12,
    iterations equal); under ``vmap`` each case against its single call."""
    jcfg = PRESSURE[kind]
    tcfg = interop.config(jcfg)
    cases = _pressure_cases()

    def one(b, d_u, d_v):
        c = t_coeffs(d_u, d_v, **KW)
        if kind in ("jacobi", "rbgs"):
            p, info = tp.solve_pressure(b, c, torch.zeros_like(b), tcfg, pin=False)
        else:
            p, info = tk.solve_pressure_krylov(b, c, torch.zeros_like(b), tcfg, d_u=d_u,
                                               d_v=d_v, **KW)
        return p, info.iterations, info.rel_residual

    def jone(b, d_u, d_v):
        c = j_coeffs(d_u, d_v, **KW)
        if kind in ("jacobi", "rbgs"):
            p, info = jp.solve_pressure(b, c, jnp.zeros_like(b), jcfg, pin=False)
        else:
            p, info = jk.solve_pressure_krylov(b, c, jnp.zeros_like(b), jcfg, d_u=d_u, d_v=d_v,
                                               **KW)
        return p, info.iterations, info.rel_residual

    singles = [one(*map(_T, c)) for c in cases]
    jfn = jax.jit(jone)
    for (p, k, rel), c in zip(singles, cases):
        want = jfn(*map(jnp.asarray, c))
        assert k.dtype == torch.int32 and int(k) == int(want[1]) > 0
        assert rel_err(p.numpy(), want[0]) <= 1e-12
        assert abs(float(rel) - float(want[2])) <= 1e-12
    got = _vmapped(one, *(torch.stack([_T(c[j]) for c in cases]) for j in range(3)))
    assert got[1].tolist() == [int(k) for _, k, _ in singles]
    assert len(set(got[1].tolist())) > 1
    for b, (p, _, rel) in enumerate(singles):
        assert torch.equal(got[0][b], p) and torch.equal(got[2][b], rel)


def _momentum_cases(seed=5):
    """Three relaxed u-momentum systems (JAX arrays) from seeded noisy
    cavity states (the lid's state plus 0.05-scale noise), viscosities
    1/100, 1/400, 1/1000."""
    rng = np.random.default_rng(seed)
    st = nf.initialize_state(nf.StructuredMesh(nx=N, ny=N), nf.lid_driven_cavity(1.0),
                             dtype=jnp.float64)
    out = []
    for mu in (1.0 / 100, 1.0 / 400, 1.0 / 1000):
        u, v = (x + 0.05 * rng.standard_normal(x.shape) for x in (st.u, st.v))
        p = jnp.asarray(0.05 * rng.standard_normal((N, N)))
        kw = dict(dx=1 / (N - 1), dy=1 / (N - 1), rho=1.0, mu=mu)
        out.append((u, relax_coefficients(u_momentum_coefficients(u, v, p, **kw), u, 0.7)))
    return out


@pytest.fixture
def loop_counts(monkeypatch):
    """The final count of each loop the momentum solves run (``krylov`` for
    GMRES, ``momentum`` for IDR(s)), call by call."""
    seen = []
    for module, slot in ((tk, 2), (tmom, 6)):
        real = module.while_loop

        def wrapped(*a, _real=real, _slot=slot):
            out = _real(*a)
            seen.append(out[_slot])
            return out

        monkeypatch.setattr(module, "while_loop", wrapped)
    return seen


def _jax_counted(fn, slot):
    """``fn`` with ``jax.lax.while_loop`` wrapped to return its count too."""
    def run(*a):
        seen = []
        real = jax.lax.while_loop

        def wl(cond, body, init):
            out = real(cond, body, init)
            seen.append(out[slot])
            return out

        jax.lax.while_loop = wl
        try:
            out = fn(*a)
        finally:
            jax.lax.while_loop = real
        return out, seen[-1]
    return run


@pytest.mark.parametrize("kind", ["gmres", "idrs"])
def test_momentum_loop(loop_counts, kind):
    """``_gmres_masked`` (restart 10, 40 Arnoldi steps) and ``_idrs_masked``
    (s = 4, the JAX package's shadow space) at tolerance 1e-7: each case
    against the JAX function (rel 1e-12, counts equal); under ``vmap`` each
    case's count its single call's and each case bit-equal."""
    cases = _momentum_cases()
    mask = interior_mask((N + 1, N), 1, 1, 1, 1)
    jmask = jnp.asarray(mask.numpy())
    shadow = jax.random.normal(jax.random.PRNGKey(0), (4, N + 1, N), jnp.float64)
    tshadow = _T(shadow)
    slot = 2 if kind == "gmres" else 6

    def one(x, *c):
        c = StencilCoeffs(*c)
        if kind == "gmres":
            out = tmom._gmres_masked(x, c, mask, 1e-7, 40, 10)
        else:
            out = tmom._idrs_masked(x, c, mask, 1e-7, 30, 4, 0.7, shadow=tshadow)
        return out, loop_counts[-1]

    def jone(x, c):
        if kind == "gmres":
            return jmom._gmres_masked(x, c, jmask, 1e-7, 40, 10)
        return jmom._idrs_masked(x, c, jmask, 1e-7, 30, 4, 0.7)

    jfn = jax.jit(_jax_counted(jone, slot))
    singles = []
    for x, c in cases:
        got, k = one(_T(x), *(_T(getattr(c, f)) for f in FIELDS))
        want, jk_ = jfn(x, c)
        assert int(k) == int(jk_) > 0
        assert rel_err(got.numpy(), want) <= 1e-12
        singles.append((got, k))
    xs = torch.stack([_T(x) for x, _ in cases])
    cs = [torch.stack([_T(getattr(c, f)) for _, c in cases]) for f in FIELDS]
    got, ks = _vmapped(one, xs, *cs)
    assert ks.tolist() == [int(k) for _, k in singles]
    assert len(set(ks.tolist())) > 1
    for b, (x, _) in enumerate(singles):
        assert torch.equal(got[b], x)


@pytest.mark.parametrize("in_dims", [(0, 0), (1, None), (None, 2)], ids=str)
def test_case_by_case_rounds_as_single(in_dims):
    """``case_by_case`` under ``vmap`` over 3 cases of 33 x 31 fields (a
    case's slice 4-byte aligned or strided), batched on any axis or
    shared: each case bit-equal to its single call on its own contiguous
    field (as a single solve holds it), for the loops' dot, norm and mean;
    a batched ``torch.dot`` rounds apart there (float32)."""
    rng = np.random.default_rng(3)
    shapes = [(3, 33, 31) if d == 0 else (33, 3, 31) if d == 1 else
              (33, 31, 3) if d == 2 else (33, 31) for d in in_dims]
    a, b = (torch.tensor(rng.normal(size=shp), dtype=torch.float32) for shp in shapes)

    def case(x, d, k):
        return x if d is None else x.select(d, k).contiguous()

    for fn, args, dims in ((tk._dot, (a, b), in_dims), (tk._norm, (a,), in_dims[:1]),
                           (tk._zero_mean, (a,), in_dims[:1])):
        if all(d is None for d in dims):
            continue
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = torch.func.vmap(fn, in_dims=dims)(*args)
        for k in range(3):
            assert torch.equal(got[k], fn(*(case(x, d, k) for x, d in zip(args, dims))))
    if in_dims == (0, 0):
        flat = torch.func.vmap(tk._flat_dot)(a, b)
        assert not all(torch.equal(flat[k], tk._flat_dot(a[k], b[k])) for k in range(3))
