"""The port's ``lax.while_loop`` (``ops/while_loop.py``) and the loops written
through it, under ``torch.func.vmap``, on the CPU.

(i) The primitive: under ``vmap`` each case stops at its own count with its
single call's operands, in one host read an iteration for every case (the
largest count + 1); a case that an enclosing ``case_mask`` freezes does
not iterate; a per-case threshold captured by the closures gives each
case's single answer; ``jvp`` raises.  (ii) ``solvers/momentum.py``'s
``_bicgstab_masked`` (plain and compensated dots) and
``_bicgstab_pair_masked``, and ``solvers/multigrid.py``'s
``multigrid_solve`` with a tolerance (interleaved and plane layouts), on
three seeded cases: under ``vmap`` each case bit-equal to its single call
in float32; in float64 the batched call against ``jax.vmap`` of the JAX
package's own function (its ``lax.while_loop``) to rel 1e-12 with every
case's iteration count equal, but for the pair loop's Re 1000 case: its v
system converges erratically, and the JAX package's ``vmap`` program
already stops two iterations from its own single solve and 6e-8 from its
iterate, so the port is held to that reading.  (The single calls against the JAX
functions: ``tests/test_torch_krylov_mg.py``'s two BiCGSTAB tests and
``tests/test_torch_mg_variants.py``'s tolerance solves.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
import naviflow_tpu.solvers.momentum as jmom
import naviflow_tpu.solvers.multigrid as jmg
from naviflow_tpu.ops.powerlaw import (relax_coefficients, u_momentum_coefficients,
                                       v_momentum_coefficients)

from naviflow_tpu_torch.ops import _cuda, while_loop
from naviflow_tpu_torch.ops.stencil import StencilCoeffs, interior_mask
from naviflow_tpu_torch.solvers import momentum as tmom
from naviflow_tpu_torch.solvers import multigrid as tmg

torch.set_num_threads(2)

MUS = (1.0 / 100, 1.0 / 400, 1.0 / 1000)
FIELDS = ("a_e", "a_w", "a_n", "a_s", "a_p", "src")
TOL = 1e-8  # the BiCGSTAB cases' tolerance: 13 to 19 iterations


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-300)


# ---------------------------------------------------------------------------
# (i) the primitive


def _halve(x, t, k):
    return x * 0.5, t, k + 1


def _above(x, t, k):
    return x > t


def _halvings(x0, t):
    k = torch.zeros((), dtype=torch.int32)
    return while_loop.while_loop(_above, _halve, x0, t, k)


def test_while_loop_cases_stop_at_their_own_counts():
    """Three cases halving to their thresholds: 2 / 5 / 9 iterations, each
    case's operands its single call's, in 10 host reads (the single calls
    read 3 + 6 + 10 times)."""
    x0 = torch.tensor([1.0, 4.0, 100.0])
    t = torch.tensor([0.3, 0.2, 0.3])
    while_loop.HOST_READS = 0
    xs, ts, ks = torch.func.vmap(_halvings)(x0, t)
    assert while_loop.HOST_READS == 10
    assert ks.tolist() == [2, 5, 9] and ks.dtype == torch.int32
    while_loop.HOST_READS = 0
    for b in range(3):
        x, _, k = _halvings(x0[b], t[b])
        assert torch.equal(xs[b], x) and int(k) == int(ks[b])
    assert while_loop.HOST_READS == 3 + 6 + 10


def test_while_loop_frozen_case_and_capture():
    """A case frozen by the enclosing ``case_mask`` does not iterate and
    keeps its operands; the others stop as alone.  A threshold captured by
    the closures (not an operand) still gives each case its single
    answer."""
    x0 = torch.tensor([1.0, 4.0, 100.0])
    t = torch.tensor([0.3, 0.2, 0.3])
    with _cuda.case_mask(torch.tensor([True, False, True])):
        xs, _, ks = torch.func.vmap(_halvings)(x0, t)
    assert ks.tolist() == [2, 0, 9] and float(xs[1]) == 4.0

    def captured(x, t):
        k = torch.zeros((), dtype=torch.int32)
        x, k = while_loop.while_loop(lambda x, k: x > t, lambda x, k: (x * 0.5, k + 1), x, k)
        return x, k

    xs, ks = torch.func.vmap(captured)(x0, t)
    assert ks.tolist() == [2, 5, 9]
    assert all(torch.equal(xs[b], captured(x0[b], t[b])[0]) for b in range(3))


def test_while_loop_raises_under_jvp():
    """The loop reads the host: under ``jvp`` it raises, as under
    ``vmap`` of a ``jvp``."""
    x0 = torch.tensor([1.0, 4.0])
    t = torch.tensor(0.3)
    with pytest.raises(RuntimeError, match="cannot run under torch.func"):
        torch.func.jvp(lambda x: _halvings(x, t)[0], (x0[0],), (x0[0],))
    with pytest.raises(RuntimeError, match="cannot run under torch.func"):
        torch.func.vmap(lambda a: torch.func.jvp(lambda x: _halvings(x, t)[0], (a,), (a,))[0])(x0)


# ---------------------------------------------------------------------------
# (ii) the loops


def _momentum_cases(mus, n=24, seed=5):
    """Three relaxed u and v momentum systems (JAX arrays, float64) from
    seeded noisy cavity states (the lid's state plus 0.05-scale noise), one
    viscosity of ``mus`` each."""
    rng = np.random.default_rng(seed)
    st = nf.initialize_state(nf.StructuredMesh(nx=n, ny=n), nf.lid_driven_cavity(1.0),
                             dtype=jnp.float64)
    out = []
    for mu in mus:
        u, v = (x + 0.05 * rng.standard_normal(x.shape) for x in (st.u, st.v))
        p = jnp.asarray(0.05 * rng.standard_normal((n, n)))
        kw = dict(dx=1 / (n - 1), dy=1 / (n - 1), rho=1.0, mu=mu)
        out.append((u, relax_coefficients(u_momentum_coefficients(u, v, p, **kw), u, 0.7),
                    v, relax_coefficients(v_momentum_coefficients(u, v, p, **kw), v, 0.7)))
    return out


def _T(x, dtype):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _port(cases, dtype):
    """The cases stacked as port tensors: (xu, cu fields, xv, cv fields)."""
    def stack(k):
        return torch.stack([_T(c[k], dtype) for c in cases])

    def coeffs(k):
        return [torch.stack([_T(getattr(c[k], f), dtype) for c in cases]) for f in FIELDS]

    return stack(0), coeffs(1), stack(2), coeffs(3)


def _with_count(fn, seen, slot):
    """``fn``'s output and its loop's count (the final operands' ``slot``)."""
    def run(*a):
        seen.clear()
        out = fn(*a)
        return out, seen[-1][slot]
    return run


@pytest.fixture
def counted_loops(monkeypatch):
    """Wrap the port's while_loop in both solver modules so that each
    call's final operands are kept (their count read by the test)."""
    seen = []
    real = while_loop.while_loop

    def wrapped(*a):
        out = real(*a)
        seen.append(out)
        return out

    monkeypatch.setattr(tmom, "while_loop", wrapped)
    monkeypatch.setattr(tmg, "while_loop", wrapped)
    return seen


def _jax_counted(fn, slot):
    """``fn`` run with ``jax.lax.while_loop`` wrapped so that it also
    returns its loop's count (the final carry's ``slot``)."""
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


@pytest.mark.parametrize("comp", [False, True], ids=["plain_dots", "compensated_dots"])
def test_bicgstab_masked_batched(counted_loops, comp):
    """``_bicgstab_masked`` under ``vmap``: float32 (Re 100 / 400 / 1000),
    each case bit-equal to its single call with its iteration count;
    float64 (the same cases) against ``jax.vmap`` of the JAX function to rel
    1e-12, counts equal (and each case's count its single call's)."""
    mask = interior_mask((25, 24), 1, 1, 1, 1)
    jmask = jnp.asarray(mask.numpy())

    def one(x, *c):
        return tmom._bicgstab_masked(x, StencilCoeffs(*c), mask, TOL, 40, compensated_dots=comp)

    counted = _with_count(one, counted_loops, 8)
    for dtype in (torch.float32, torch.float64):
        cases = _momentum_cases(MUS)
        x, c, _, _ = _port(cases, dtype)
        got, ks = torch.func.vmap(counted)(x, *c)
        singles = [counted(x[b], *(a[b] for a in c)) for b in range(3)]
        assert [int(k) for k in ks] == [int(k) for _, k in singles]
        assert len({int(k) for k in ks}) > 1
        if dtype == torch.float32:
            assert all(torch.equal(got[b], singles[b][0]) for b in range(3))
            continue

        def jone(x, c):
            return jmom._bicgstab_masked(x, c, jmask, TOL, 40, compensated_dots=comp)

        jx = jnp.stack([cs[0] for cs in cases])
        jc = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[cs[1] for cs in cases])
        want, jk = jax.jit(jax.vmap(_jax_counted(jone, 8)))(jx, jc)
        assert [int(k) for k in ks] == [int(k) for k in np.asarray(jk)]
        assert rel_err(got.numpy(), want) <= 1e-12


def test_bicgstab_pair_masked_batched(counted_loops):
    """``_bicgstab_pair_masked`` (the large-grid loop after K8) under
    ``vmap``: float32 and float64 (Re 100 / 400 / 1000) bit-equal to each
    single call with its count; float64 against ``jax.vmap`` of the JAX
    function: Re 100 and 400 to rel 1e-12 with counts equal; Re 1000, where
    the JAX ``vmap`` program's case sits a gap ``g`` (> 1e-12) from the JAX
    single solve and its count differs, within 4 g."""
    mu_ = interior_mask((25, 24), 1, 1, 1, 1)
    mv_ = interior_mask((24, 25), 1, 1, 1, 1)

    def one(xu, xv, *c):
        return tmom._bicgstab_pair_masked(xu, StencilCoeffs(*c[:6]), mu_, xv,
                                          StencilCoeffs(*c[6:]), mv_, TOL, 40)

    counted = _with_count(one, counted_loops, 8)
    cases = _momentum_cases(MUS)
    for dtype in (torch.float32, torch.float64):
        xu, cu, xv, cv = _port(cases, dtype)
        (gu, gv), ks = torch.func.vmap(counted)(xu, xv, *cu, *cv)
        singles = [counted(xu[b], xv[b], *(a[b] for a in cu + cv)) for b in range(3)]
        assert [int(k) for k in ks] == [int(k) for _, k in singles]
        assert all(torch.equal(gu[b], s[0][0]) and torch.equal(gv[b], s[0][1])
                   for b, s in enumerate(singles))
        if dtype == torch.float32:
            continue

        def jone(xu, cu, xv, cv):
            return jmom._bicgstab_pair_masked(xu, cu, jnp.asarray(mu_.numpy()), xv, cv,
                                              jnp.asarray(mv_.numpy()), TOL, 40)

        def jstack(k):
            return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[cs[k] for cs in cases])

        (wu, wv), jk = jax.jit(jax.vmap(_jax_counted(jone, 8)))(jstack(0), jstack(1), jstack(2),
                                                        jstack(3))
        assert [int(k) for k in ks[:2]] == [int(k) for k in np.asarray(jk)[:2]]
        for b in range(2):
            assert rel_err(gu[b].numpy(), wu[b]) <= 1e-12
            assert rel_err(gv[b].numpy(), wv[b]) <= 1e-12
        # Re 1000: the JAX vmap program's case against the JAX single solve
        (su, sv), sk = jax.jit(_jax_counted(jone, 8))(*cases[2])
        assert int(sk) != int(np.asarray(jk)[2])
        gap = max(rel_err(np.asarray(wu[2]), su), rel_err(np.asarray(wv[2]), sv))
        assert gap > 1e-12
        assert rel_err(gu[2].numpy(), wu[2]) <= 4 * gap
        assert rel_err(gv[2].numpy(), wv[2]) <= 4 * gap


def _pressure_cases(n=24, seed=7):
    """Three seeded positive d-field pairs, each rougher than the last, and
    right-hand sides the consistent operator admits (zero at the four
    corner cells, which have no face link, zero mean elsewhere); numpy,
    float64."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(3):
        d_u = (rng.random((n + 1, n)) * (1 + 8 * k) + 0.5) / n
        d_v = (rng.random((n, n + 1)) * (1 + 8 * k) + 0.5) / n
        b = rng.normal(size=(n, n))
        corners = np.zeros((n, n), dtype=bool)
        corners[[0, 0, -1, -1], [0, -1, 0, -1]] = True
        b[corners] = 0.0
        b[~corners] -= b[~corners].mean()
        out.append((d_u, d_v, b))
    return out


@pytest.mark.parametrize("layout", ["interleaved", "plane"])
def test_multigrid_tolerance_loop_batched(layout):
    """``multigrid_solve`` with a tolerance (check every 2 cycles) under
    ``vmap``: float32 each case bit-equal to its single solve (p, cycles,
    rel); float64 against ``jax.vmap`` of the JAX ``multigrid_solve`` to
    rel 1e-12 (``rel``, a residual already relative to ||b||, within 1e-12)
    with the cycles equal (each case's its single solve's); the cases'
    cycles differ."""
    n = 24
    cases = _pressure_cases(n)
    cfg = tmg.MultigridConfig(tolerance=1e-5, max_cycles=40, check_every=2, fine_layout=layout)
    kw = dict(dx=1.0 / n, dy=1.0 / n, rho=1.0, variant="consistent")

    def one(b, d_u, d_v):
        p, info = tmg.multigrid_solve(b, d_u, d_v, torch.zeros_like(b), cfg, **kw)
        return p, info.iterations, info.rel_residual

    for dtype in (torch.float32, torch.float64):
        b, du, dv = (torch.stack([_T(c[k], dtype) for c in cases]) for k in (2, 0, 1))
        got = torch.func.vmap(one)(b, du, dv)
        singles = [one(b[k], du[k], dv[k]) for k in range(3)]
        assert [int(c) for c in got[1]] == [int(s[1]) for s in singles]
        assert len({int(c) for c in got[1]}) > 1
        if dtype == torch.float32:
            for k, s in enumerate(singles):
                assert torch.equal(got[0][k], s[0]) and torch.equal(got[2][k], s[2])
            continue
        jcfg = jmg.MultigridConfig(tolerance=1e-5, max_cycles=40, check_every=2,
                                   fine_layout=layout)

        def jone(b, d_u, d_v):
            p, info = jmg.multigrid_solve(b, d_u, d_v, jnp.zeros_like(b), jcfg, **kw)
            return p, info.iterations, info.rel_residual

        want = jax.jit(jax.vmap(jone))(*(jnp.stack([c[k] for c in cases]) for k in (2, 0, 1)))
        assert [int(c) for c in got[1]] == [int(c) for c in np.asarray(want[1])]
        assert rel_err(got[0].numpy(), want[0]) <= 1e-12
        # rel is ||b - A p|| / ||b||: its rounding is relative to ||b||
        assert np.max(np.abs(got[2].numpy() - np.asarray(want[2]))) <= 1e-12
