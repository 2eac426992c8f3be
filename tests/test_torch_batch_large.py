"""The case axis of K1, K2a, K2b and K3 in the PyTorch port, on the CPU.

(a) The batched K3's plain version (``ops/mg.fused_vcycle_batched``, the
CPU path and the kernel's oracle) on three seeded even 32^2 -> 4^2
hierarchies against ``jax.vmap`` of the JAX package's Pallas
``fused_vcycle`` in interpret mode.  (b) The batched K2a and K2b
(``ops/strip.strip_down_batched`` / ``strip_up_batched``) on three 64^2
five-point and nine-point levels against ``jax.vmap`` of the Pallas strips.
(c) The batched K1 (``ops/asmcheby.fused_asmcheby_pair_batched``) at 64^2,
three cases, against ``jax.vmap`` of the Pallas kernel with one shared
viscosity, and against one single Pallas call per case with each case's
own (the JAX kernel closes over ``mu``: under ``jax.vmap`` a per-case
viscosity does not trace).  Each at the tolerances of the single kernels'
tests.  (g) Frozen cases.  (h) The batched C entries' slots and case
strides, parsed from ``csrc/``, against the wrappers' pointer arrays
through a library that records its calls.  (i) Under ``jvp`` the four
kernels still raise.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import naviflow_tpu as nf
from naviflow_tpu.core.bc import apply_velocity_bcs
from naviflow_tpu.ops.pallas_asmcheby import fused_asmcheby_pair as j_asmcheby
from naviflow_tpu.ops.pallas_mg import fused_vcycle as j_vcycle
from naviflow_tpu.ops.pallas_strip import strip_down as j_down
from naviflow_tpu.ops.pallas_strip import strip_up as j_up
from naviflow_tpu.ops.powerlaw import (relax_coefficients, u_momentum_coefficients,
                                       v_momentum_coefficients)
from naviflow_tpu.ops.stencil9 import Stencil9 as JStencil9
from naviflow_tpu.solvers.momentum import _bounds_from_rho, _u_interior_mask, _v_interior_mask
from naviflow_tpu.solvers.multigrid import MultigridConfig as JMG

from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops import _cuda, asmcheby, mg, powerlaw, strip
from naviflow_tpu_torch.ops.poisson import poisson_coefficients
from naviflow_tpu_torch.ops.stencil9 import Stencil9, from_poisson, galerkin_coarsen
from naviflow_tpu_torch.ops.transfer_cc import prolong_cc, restrict_cc
from naviflow_tpu_torch.solvers.multigrid import MultigridConfig, build_levels

torch.set_num_threads(2)

CSRC = Path(mg.__file__).resolve().parent.parent / "csrc"
NAMES = ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")
RES = (100.0, 400.0, 1000.0)
ALPHA = 0.7


def T(x, dtype=torch.float32):
    return interop.tensor(x, dtype=dtype)


def rel_err(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-30)


def _to_jax(st):
    return JStencil9(**{k: jnp.asarray(getattr(st, k).numpy()) for k in NAMES})


def _stack_st(sts):
    return Stencil9(*(torch.stack([getattr(st, k) for st in sts]) for k in NAMES))


def _fine_stencil(n, rng):
    d_u = torch.as_tensor(rng.uniform(0.5, 1.5, (n + 1, n)), dtype=torch.float32)
    d_v = torch.as_tensor(rng.uniform(0.5, 1.5, (n, n + 1)), dtype=torch.float32)
    return from_poisson(poisson_coefficients(d_u, d_v, dx=1.0 / n, dy=1.0 / n, rho=1.0,
                                             variant="consistent"))


# ---------------------------------------------------------------------------
# (a) K3


def _even_cases(n=32, seed=5):
    """Three seeded even n^2 hierarchies (the port's composed build, which
    the JAX package's matches) and right-hand sides."""
    rng = np.random.default_rng(seed)
    tcfg = MultigridConfig(pre_smoothing=1, post_smoothing=1, coarsest_sweeps=16)
    levels, bs = [], []
    for _ in RES:
        d_u = torch.as_tensor(rng.random((n + 1, n)) + 0.5, dtype=torch.float32)
        d_v = torch.as_tensor(rng.random((n, n + 1)) + 0.5, dtype=torch.float32)
        levels.append(build_levels(d_u, d_v, tcfg, dx=1.0 / n, dy=1.0 / n, rho=1.0,
                                   variant="consistent"))
        b = rng.normal(size=(n, n)).astype(np.float32)
        bs.append(b - b.mean())
    stacked = [(_stack_st([case[lvl][0] for case in levels]), shp, five, lam)
               for lvl, (_, shp, five, lam) in enumerate(levels[0])]
    return levels, stacked, np.stack(bs), tcfg


def test_k3_batched_plain_matches_jax_vmap_of_pallas():
    """The batched K3's plain version on three even 32^2 -> 4^2
    hierarchies, two chained cycles: each case within 1e-5 of the cycle
    output's scale (the single K3 test's tolerance) of ``jax.vmap`` of the
    Pallas ``fused_vcycle`` in interpret mode; a frozen case gets its
    iterate back and the others keep their bits."""
    levels, stacked, b, tcfg = _even_cases()
    assert [lv[1] for lv in stacked] == [(32, 32), (16, 16), (8, 8), (4, 4)]
    assert mg.supports_fused(levels[0], tcfg)
    jcfg = JMG(pre_smoothing=1, post_smoothing=1, coarsest_sweeps=16)
    meta = [lv[1:] for lv in stacked]
    jst = [JStencil9(**{k: jnp.asarray(getattr(st, k).numpy()) for k in NAMES})
           for st, _, _, _ in stacked]

    def one(p, bb, sts):
        return j_vcycle(p, bb, [(st, *m) for st, m in zip(sts, meta)], jcfg, interpret=True)

    jp, tp = jnp.zeros(b.shape, jnp.float32), torch.zeros(b.shape)
    for _ in range(2):
        jp = jax.vmap(one)(jp, jnp.asarray(b), jst)
        tp = mg.fused_vcycle_batched(tp, T(b), stacked, tcfg)
        for k in range(3):
            assert rel_err(tp[k], jp[k]) < 1e-5, k
    frozen = mg.fused_vcycle_batched(tp, T(b), stacked, tcfg,
                                     active=torch.tensor([True, False, True]))
    full = mg.fused_vcycle_batched(tp, T(b), stacked, tcfg)
    assert torch.equal(frozen[1], tp[1])
    assert torch.equal(frozen[0], full[0]) and torch.equal(frozen[2], full[2])
    # each case is its single plain cycle's
    for k in range(3):
        assert torch.equal(full[k], mg.fused_vcycle(tp[k], T(b[k]), levels[k], tcfg))
    assert mg.VC_BATCH_LAUNCHES == 0 and mg.LAUNCHES == 0


# ---------------------------------------------------------------------------
# (b) K2a, K2b


def _strip_cases(five, n=64):
    """Three seeded 64^2 levels: 5-point operators, or the Galerkin
    coarsenings of 128^2 ones; p, b and a coarse correction each."""
    rng = np.random.default_rng(4 if five else 13)
    sts = []
    for _ in RES:
        st = _fine_stencil(n if five else 2 * n, rng)
        sts.append(st if five else galerkin_coarsen(st, restrict_cc, prolong_cc, n, n))
    p, b = (rng.normal(size=(3, n, n)).astype(np.float32) for _ in range(2))
    ec = rng.normal(size=(3, n // 2, n // 2)).astype(np.float32)
    return sts, p, b, ec


@pytest.mark.parametrize("five", [True, False], ids=["five", "nine"])
def test_k2_batched_plain_matches_jax_vmap_of_pallas(five):
    """The batched K2a and K2b plain versions on three 64^2 levels (5-point,
    and 9-point Galerkin ones) against ``jax.vmap`` of the Pallas strips in
    interpret mode, rtol 1e-5 / atol 1e-4 (the single strip tests'); each
    case bit-equal to its single plain call; a frozen case gets its p (and,
    down, a zero coarse residual)."""
    sts, p, b, ec = _strip_cases(five)
    st = _stack_st(sts)
    jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[_to_jax(s) for s in sts])
    jcfg, tcfg = JMG(pre_smoothing=1, post_smoothing=1), MultigridConfig(pre_smoothing=1,
                                                                          post_smoothing=1)
    want_x, want_rc = jax.vmap(lambda pp, bb, s: j_down(pp, bb, s, jcfg, five=five,
                                                        interpret=True))(p, b, jst)
    got_x, got_rc = strip.strip_down_batched(T(p), T(b), st, tcfg, five)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_rc.numpy(), np.asarray(want_rc), rtol=1e-5, atol=1e-4)
    want_up = jax.vmap(lambda pp, bb, s, e: j_up(pp, bb, s, e, jcfg, five=five,
                                                 interpret=True))(want_x, b, jst, ec)
    got_up = strip.strip_up_batched(T(want_x), T(b), st, T(ec), tcfg, five)
    np.testing.assert_allclose(got_up.numpy(), np.asarray(want_up), rtol=1e-5, atol=1e-4)
    for k in range(3):
        x1, rc1 = strip.strip_down(T(p[k]), T(b[k]), sts[k], tcfg, five)
        assert torch.equal(got_x[k], x1) and torch.equal(got_rc[k], rc1)
        assert torch.equal(got_up[k], strip.strip_up(T(want_x[k]), T(b[k]), sts[k],
                                                     T(ec[k]), tcfg, five))
    active = torch.tensor([True, True, False])
    fx, frc = strip.strip_down_batched(T(p), T(b), st, tcfg, five, active=active)
    fu = strip.strip_up_batched(T(want_x), T(b), st, T(ec), tcfg, five, active=active)
    assert torch.equal(fx[2], T(p[2])) and not frc[2].any() and frc.shape == got_rc.shape
    assert torch.equal(fu[2], T(want_x[2]))
    assert torch.equal(fx[:2], got_x[:2]) and torch.equal(frc[:2], got_rc[:2])
    assert torch.equal(fu[:2], got_up[:2])
    assert strip.STRIP_DOWN_BATCH_LAUNCHES == strip.STRIP_UP_BATCH_LAUNCHES == 0


# ---------------------------------------------------------------------------
# (c) K1


def _k1_cases(n=64, seed=11):
    """Three noisy cavity states (each its own seed), the Gershgorin bounds
    of each one's own assembly at its own viscosity."""
    mesh, bc = nf.StructuredMesh(nx=n, ny=n), nf.lid_driven_cavity(1.0)
    st = nf.initialize_state(mesh, bc, dtype=jnp.float32)
    kw = dict(dx=1.0 / (n - 1), dy=1.0 / (n - 1), rho=1.0)
    out = []
    for k, re_ in enumerate(RES):
        rng = np.random.default_rng(seed + k)
        u = jnp.asarray(st.u + 0.1 * rng.normal(size=st.u.shape), jnp.float32)
        v = jnp.asarray(st.v + 0.1 * rng.normal(size=st.v.shape), jnp.float32)
        p = jnp.asarray(rng.normal(size=st.p.shape), jnp.float32)
        u, v = apply_velocity_bcs(u, v, bc)
        a = dict(kw, mu=1.0 / re_)

        def raw_rho(c_un, c_rel, mask):
            safe = jnp.where(c_rel.a_p == 0, 1.0, c_rel.a_p)
            nb = jnp.abs(c_un.a_e) + jnp.abs(c_un.a_w) + jnp.abs(c_un.a_n) + jnp.abs(c_un.a_s)
            return jnp.max(jnp.where(mask, nb / safe, 0.0))

        cu = u_momentum_coefficients(u, v, p, **a)
        cv = v_momentum_coefficients(u, v, p, **a)
        bu = _bounds_from_rho(raw_rho(cu, relax_coefficients(cu, u, ALPHA),
                                      _u_interior_mask(u.shape)), 1.05)
        bv = _bounds_from_rho(raw_rho(cv, relax_coefficients(cv, v, ALPHA),
                                      _v_interior_mask(v.shape)), 1.05)
        out.append(dict(u=u, v=v, p=p, mu=a["mu"], bu=bu, bv=bv))
    return out, kw


def _k1_batch_args(cases, kw):
    fields = [T(jnp.stack([c[f] for c in cases])) for f in ("u", "v", "p")]
    bounds_u = tuple(T(jnp.stack([c["bu"][i] for c in cases])) for i in range(3))
    bounds_v = tuple(T(jnp.stack([c["bv"][i] for c in cases])) for i in range(3))
    return fields, bounds_u, bounds_v


def _check_k1(got, want, k=None):
    pick = (lambda x: x[k]) if k is not None else (lambda x: x)
    for i, tol in enumerate([2e-5, 5e-5, 2e-5, 5e-5, 2e-5, 2e-5]):
        assert rel_err(pick(got[i]), want[i]) < tol, i
    for name in ("a_e", "a_w", "a_n", "a_s", "diag"):
        assert rel_err(pick(getattr(got[6], name)), getattr(want[6], name)) < 2e-5, name
    assert rel_err(pick(got[7]), want[7]) < 1e-6 and rel_err(pick(got[8]), want[8]) < 1e-6


def test_k1_batched_plain_matches_jax_vmap_with_shared_mu():
    """The batched K1's plain version at 64^2, three states sharing Re 100's
    viscosity (conductance rows equal), against ``jax.vmap`` of the Pallas
    kernel in interpret mode (its viscosity a closed-over constant) at the
    single K1 test's tolerances (2e-5 on fields and operators, 5e-5 on
    residuals, 1e-6 on the maxima)."""
    cases, kw = _k1_cases()
    mu = cases[0]["mu"]
    (u, v, p), bu, bv = _k1_batch_args(cases, kw)
    stack = lambda key: tuple(jnp.stack([c[key][i] for c in cases]) for i in range(3))  # noqa: E731
    want = jax.vmap(lambda uu, vv, pp, b_u, b_v: j_asmcheby(
        uu, vv, pp, mu=mu, alpha=ALPHA, degree=4, bounds_u=b_u, bounds_v=b_v,
        poisson_variant="consistent", interpret=True, **kw))(
        *(jnp.stack([c[f] for c in cases]) for f in ("u", "v", "p")), stack("bu"), stack("bv"))
    visc = powerlaw.case_conductances([mu] * 3, kw["dx"], kw["dy"], torch.float32)
    got = asmcheby.fused_asmcheby_pair_batched(u, v, p, visc=visc, alpha=ALPHA, degree=4,
                                               bounds_u=bu, bounds_v=bv, **kw)
    for k in range(3):
        _check_k1(got, jax.tree_util.tree_map(lambda x: x[k], want), k)
    assert asmcheby.BATCH_LAUNCHES == 0 and asmcheby.LAUNCHES == 0


def test_k1_batched_plain_matches_single_pallas_calls_per_mu():
    """The batched K1's plain version at 64^2 with each case's own viscosity
    (Re 100 / 400 / 1000, conductance rows) against one single Pallas call a
    case in interpret mode, at the single K1 test's tolerances; each case
    bit-equal to its single plain call with the Python viscosity; a frozen
    case gets its u and v back and zeros in every other output."""
    cases, kw = _k1_cases()
    (u, v, p), bu, bv = _k1_batch_args(cases, kw)
    visc = powerlaw.case_conductances([c["mu"] for c in cases], kw["dx"], kw["dy"],
                                      torch.float32)
    args = dict(visc=visc, alpha=ALPHA, degree=4, bounds_u=bu, bounds_v=bv, **kw)
    got = asmcheby.fused_asmcheby_pair_batched(u, v, p, **args)
    for k, c in enumerate(cases):
        want = j_asmcheby(c["u"], c["v"], c["p"], mu=c["mu"], alpha=ALPHA, degree=4,
                          bounds_u=c["bu"], bounds_v=c["bv"], poisson_variant="consistent",
                          interpret=True, **kw)
        _check_k1(got, want, k)
        single = asmcheby.fused_asmcheby_pair(
            u[k], v[k], p[k], mu=c["mu"], alpha=ALPHA, degree=4,
            bounds_u=tuple(s[k] for s in bu), bounds_v=tuple(s[k] for s in bv), **kw)
        for g, w in zip(asmcheby._flat(got), asmcheby._flat(single)):
            assert torch.equal(g[k], w), k
    frozen = asmcheby._flat(asmcheby.fused_asmcheby_pair_batched(
        u, v, p, active=torch.tensor([False, True, True]), **args))
    assert torch.equal(frozen[0][0], u[0]) and torch.equal(frozen[2][0], v[0])
    assert not any(bool(x[0].any()) for i, x in enumerate(frozen) if i not in (0, 2))
    assert all(torch.equal(f[1:], g[1:]) for f, g in zip(frozen, asmcheby._flat(got)))


# ---------------------------------------------------------------------------
# (h) the batched C entries


def _src(name):
    return (CSRC / name).read_text()


def _body(src, signature):
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


class _Recorder:
    """Records the batched K1, K2a, K2b and K3 entries' arrays."""

    def __init__(self):
        self.calls = []

    def _record(self, name, ptrs, ip, fp, stream):
        self.calls.append((name, list(ptrs), list(ip), list(fp), stream))
        return 0

    def __getattr__(self, name):
        if name.endswith("_batched"):
            return lambda *a: self._record(name, *a)
        raise AttributeError(name)


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_of", lambda x: 7)
    monkeypatch.setattr(_cuda, "kernel_device", lambda x: True)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for module, name in ((asmcheby, "_BATCH"), (strip, "_DOWN_BATCH"), (strip, "_UP_BATCH"),
                         (mg, "_VC_BATCH")):
        monkeypatch.setattr(module, name, {})
    for module, name in ((asmcheby, "BATCH_LAUNCHES"), (strip, "STRIP_DOWN_BATCH_LAUNCHES"),
                         (strip, "STRIP_UP_BATCH_LAUNCHES"), (mg, "VC_BATCH_LAUNCHES")):
        monkeypatch.setattr(module, name, getattr(module, name))
    return lib


def test_k3_batched_slots_match_c_entry(recorder):
    """``nf_fused_vcycle_batched`` reads nf_fused_vcycle's 11 L + 1 slots for
    case 0 and, after the active flags, their strides (``read_levels`` and
    ``read_cycle``, the single entry's own reads, twice); B after the
    levels' integers; each case's levels moved by ``levels_case``, p_in by
    its stride; a frozen case copies p_in before any cluster barrier.  The
    wrapper: the stencils by address and stride (0: shared), the global
    coarse levels' scratch B copies, kept across calls; one output."""
    src = _src("mg.cu")
    entry = _body(src, "NF_EXPORT int nf_fused_vcycle_batched(")
    assert "const int half = 11 * L + 2;" in entry
    assert "read_levels(SB.P.M, ptrs, ip + VC_IP_LEVELS, L)" in entry
    assert "read_levels(SB.S.M, ptrs + half, ip + VC_IP_LEVELS, L)" in entry
    assert "SB.P.p_in = reinterpret_cast<const float*>(ptrs[11 * L]);" in entry
    assert "SB.S.p_in = reinterpret_cast<const float*>(ptrs[half + 11 * L]);" in entry
    assert "SB.active = reinterpret_cast<const bool*>(ptrs[half - 1]);" in entry
    assert "SB.active_stride = reinterpret_cast<const bool*>(ptrs[2 * half - 1]);" in entry
    assert "const int cases = ip[VC_IP_LEVELS + 3 * L];" in entry
    kernel = _body(src, "__global__ void __launch_bounds__(NF_CL_THREADS, 1) "
                        "vcycle_kernel_batched(")
    assert "levels_case(P.M.lv, SB.S.M.lv, P.M.L, b);" in kernel
    assert "nf_case_shift(P.p_in, SB.S.p_in, b);" in kernel
    assert kernel.index("if (!on)") < kernel.index("nf_vc_cycle<false>(")
    assert "if (kernel == 3) return nf_max_active_clusters(vcycle_kernel_batched" in src
    n, cases = 256, 3
    cfg = MultigridConfig(pre_smoothing=1, post_smoothing=1, coarsest_sweeps=32)
    shapes = [(256, 256), (128, 128), (64, 64), (32, 32), (16, 16), (8, 8), (4, 4)]
    shared = torch.zeros(128, 128)
    levels = [(Stencil9(*[torch.zeros(cases, *shp) for _ in NAMES]), shp, lvl == 0, None)
              for lvl, shp in enumerate(shapes)]
    levels[1] = (Stencil9(*[shared.expand(cases, 128, 128)] * 9), (128, 128), False, None)
    p, b = torch.zeros(cases, n, n), torch.zeros(cases, n, n)
    out = mg.fused_vcycle_batched(p, b, levels, cfg)
    mg.fused_vcycle_batched(p, b, levels, cfg, active=torch.tensor([True, False, True]))
    (e1, p1, ip1, fp1, s1), (_, p2, ip2, _, _) = recorder.calls
    L, half = 7, 11 * 7 + 2
    first, _ = mg.vcycle_layout(shapes)
    assert first == 3 and e1 == "nf_fused_vcycle_batched" and s1 == 7 and len(p1) == 2 * half
    assert ip1 == ip2 == [L, 1, 1, 32, first] + [x for lvl, shp in enumerate(shapes)
                                                 for x in (*shp, int(lvl == 0))] + [cases]
    assert fp1 == pytest.approx([cfg.omega])
    for lvl, (st, shp, five, _) in enumerate(levels):
        k = 5 if five else 9
        assert p1[11 * lvl:11 * lvl + k] == [getattr(st, nm).data_ptr() for nm in NAMES[:k]]
        want = 0 if lvl == 1 else 4 * shp[0] * shp[1]
        assert p1[half + 11 * lvl:half + 11 * lvl + k] == [want] * k
        if lvl >= first:
            assert p1[11 * lvl + 9:11 * lvl + 11] == [0, 0]
    for lvl in (1, 2):  # the global coarse levels' scratch: B copies, kept
        ni = shapes[lvl][0]
        assert p1[11 * lvl + 9] == p2[11 * lvl + 9] != 0
        assert p1[half + 11 * lvl + 9] == p1[half + 11 * lvl + 10] == 8 * ni * ni
    assert p1[9] == out.data_ptr() and p1[half + 9] == 4 * n * n
    assert p1[10] == b.data_ptr() and p1[11 * L] == p.data_ptr()
    assert p1[half + 10] == p1[half + 11 * L] == 4 * n * n
    assert p1[half - 1] != p2[half - 1] and p1[2 * half - 1] == 1
    assert tuple(out.shape) == (cases, n, n) and mg.VC_BATCH_LAUNCHES == 2


@pytest.mark.parametrize("up", [False, True], ids=["down", "up"])
def test_k2_batched_slots_match_c_entry(recorder, up):
    """``nf_strip_down_batched`` / ``nf_strip_up_batched`` read the single
    entry's ns + 4 slots for case 0 (``launch_down`` / ``launch_up``, its own
    reads, into ``read``), the active flags, then the strides of all ns + 5;
    B after the single entry's four integers; the grid's z axis is the
    cases, each block's pointers moved by its case's strides; a frozen case's
    blocks copy p and zero their coarse residual.  The wrapper: the inputs
    by address and stride (0: shared), one output allocation (down: p and
    the coarse residual of a case one stride apart)."""
    src = _src("strip.cu")
    entry = _body(src, "int launch_batched(")
    assert "const int half = ns + 5;" in entry
    assert "int err = read(ptrs, ip, fp, stream, &SB.P);" in entry
    assert "if (!err) err = read(ptrs + half, ip, fp, stream, &SB.S);" in entry
    assert "const int cases = ip[4];" in entry
    assert "SB.P.vec = SB.P.vec && SB.S.vec;" in entry
    assert "return launch_batched(false, ptrs, ip, fp, stream);" in _body(
        src, "NF_EXPORT int nf_strip_down_batched(")
    assert "return launch_batched(true, ptrs, ip, fp, stream);" in _body(
        src, "NF_EXPORT int nf_strip_up_batched(")
    case = _body(src, "__device__ __forceinline__ bool strip_case(")
    for field in ("P.a[a], SB.S.a[a]", "P.ec, SB.S.ec", "P.out_p, SB.S.out_p",
                  "P.out_rc, SB.S.out_rc"):
        assert f"nf_case_shift({field}, b);" in case
    assert "const int b = (int)blockIdx.z;" in case
    assert "dim3((P.ny + DOWN_TJ - 1) / DOWN_TJ, (P.nx + TILE - 1) / TILE, cases)" in src
    five, cases, n = up, 3, 64
    ns = 5 if five else 9
    st = Stencil9(*[torch.zeros(cases, n, n) for _ in NAMES])
    shared_b = torch.zeros(n, n).expand(cases, n, n)
    p = torch.zeros(cases, n, n)
    cfg = MultigridConfig(pre_smoothing=1, post_smoothing=2)
    active = torch.tensor([True, False, True])
    if up:
        ec = torch.zeros(cases, n // 2, n // 2)
        out = strip.strip_up_batched(p, shared_b, st, ec, cfg, five, active=active)
        (e1, p1, ip1, fp1, s1), = recorder.calls
        assert e1 == "nf_strip_up_batched" and ip1 == [n, n, int(five), 2, cases]
        ins = [p, shared_b, *[getattr(st, k) for k in NAMES[:ns]], ec]
        assert p1[:ns + 3] == [a.data_ptr() for a in ins] and p1[ns + 3] == out.data_ptr()
        strides = [4 * n * n, 0] + [4 * n * n] * ns + [4 * n * n // 4, 4 * n * n]
    else:
        x, rc = strip.strip_down_batched(p, shared_b, st, cfg, five, active=active)
        (e1, p1, ip1, fp1, s1), = recorder.calls
        assert e1 == "nf_strip_down_batched" and ip1 == [n, n, int(five), 1, cases]
        ins = [p, shared_b, *[getattr(st, k) for k in NAMES[:ns]]]
        assert p1[:ns + 2] == [a.data_ptr() for a in ins]
        assert p1[ns + 2:ns + 4] == [x.data_ptr(), rc.data_ptr()]
        assert rc.data_ptr() - x.data_ptr() == 4 * n * n
        step = 4 * (n * n + n * n // 4)
        assert x.stride(0) * 4 == step and rc.stride(0) * 4 == step
        strides = [4 * n * n, 0] + [4 * n * n] * ns + [step, step]
    half = ns + 5
    assert len(p1) == 2 * half and s1 == 7 and fp1 == pytest.approx([1.0])
    assert p1[half:half + ns + 4] == strides
    assert p1[half - 1] == active.data_ptr() and p1[2 * half - 1] == 1


def test_k1_batched_slots_match_c_entry(recorder):
    """``nf_asmcheby_pair_batched`` reads launch_asmcheby's 21 slots for case
    0 (its own reads, into ``read``), the conductances and the active flags,
    then the strides of all 23; B after the four integers; each case's view
    moves every pointer by its stride and takes De and Dn from its
    conductance row; the maxima's +0.0 is one 2-D memset over the cases.
    The wrapper: inputs and the six interval scalars by address and stride,
    the outputs one buffer of B single layouts (stride one layout)."""
    src = _src("asmcheby.cu")
    entry = _body(src, "int launch_asmcheby_batched(")
    assert "constexpr int N = 21, HALF = N + 2;" in entry
    assert "launch_asmcheby<false>(ptrs, ip, fp, stream, &SB.P);" in entry
    assert "launch_asmcheby<false>(ptrs + HALF, ip, fp, stream, &SB.S);" in entry
    assert "SB.visc = reinterpret_cast<const float*>(ptrs[N]);" in entry
    assert "SB.active = reinterpret_cast<const bool*>(ptrs[N + 1]);" in entry
    assert "SB.cases = ip[4];" in entry
    assert "cudaMemset2DAsync(SB.P.gmax, pitch, 0, 2 * sizeof(float), SB.cases, s)" in entry
    assert "return launch_asmcheby_batched(ptrs, ip, fp, stream);" in src
    case = _body(_src("asmcheby.cuh"), "__device__ __forceinline__ void k1_case(")
    assert "P.De = visc[0];" in case and "P.Dn = visc[1];" in case
    assert "for (int k = 0; k < 9; ++k) nf_case_shift(*ins[k], *sin[k], b);" in case
    assert "for (int k = 0; k < 12; ++k) nf_case_shift(*outs[k], *sout[k], b);" in case
    assert len(asmcheby.SLOTS) == 21
    cases, n = 3, 64
    u, v, p = torch.zeros(cases, n + 1, n), torch.zeros(cases, n, n + 1), torch.zeros(cases, n, n)
    shared = torch.tensor(1.0)
    bu = (shared.expand(cases), torch.ones(cases), torch.ones(cases))
    visc = powerlaw.case_conductances(list(1.0 / np.array(RES)), 0.1, 0.1, torch.float32)
    out = asmcheby.fused_asmcheby_pair_batched(u, v, p, dx=0.1, dy=0.1, rho=1.0, visc=visc,
                                               alpha=ALPHA, degree=4, bounds_u=bu, bounds_v=bu)
    (e1, p1, ip1, fp1, s1), = recorder.calls
    half = 23
    assert e1 == "nf_asmcheby_pair_batched" and len(p1) == 2 * half and s1 == 7
    assert ip1 == [n, n, 4, 0, cases]
    assert fp1[2:4] == [0.0, 0.0] and fp1[:2] == pytest.approx([0.05, 0.05])
    assert p1[:3] == [u.data_ptr(), v.data_ptr(), p.data_ptr()]
    assert p1[half:half + 3] == [4 * (n + 1) * n, 4 * n * (n + 1), 4 * n * n]
    assert p1[half + 3:half + 9] == [0, 4, 4, 0, 4, 4]
    layout, total = asmcheby.output_layout(n, n)
    base = out[0].data_ptr()
    assert p1[9:21] == [base + 4 * off for off, _ in layout]
    assert p1[half + 9:half + 21] == [4 * total] * 12
    assert p1[21] == visc.data_ptr() and p1[half + 21] == 16
    assert p1[half + 22] == 1 and asmcheby.BATCH_LAUNCHES == 1
    assert tuple(out[0].shape) == (cases, n + 1, n) and out[0].stride(0) == total
    assert tuple(out[7].shape) == (cases,) and out[8].data_ptr() - out[7].data_ptr() == 4
    assert re.search(r'"nf_asmcheby_pair_batched", "nf_strip_down_batched", '
                     r'"nf_strip_up_batched",\s*"nf_fused_vcycle_batched"',
                     Path(_cuda.__file__).read_text())


# ---------------------------------------------------------------------------
# (i) transforms


def test_k1_k2_k3_raise_under_jvp():
    """Under ``jvp`` K1, K2a, K2b and K3 (a batching rule, no derivative)
    raise at their launch on a CUDA tensor, as every kernel does; nothing
    gives way to a plain version."""
    mode = FakeTensorMode()
    with mode:
        x = torch.zeros(16, 16, device="cuda")
        st = Stencil9(*[torch.zeros(16, 16, device="cuda")] * 9)
        levels = [(st, (16, 16), True, None),
                  (Stencil9(*[torch.zeros(8, 8, device="cuda")] * 9), (8, 8), False, None)]
        cfg = MultigridConfig()
        u, v = torch.zeros(17, 16, device="cuda"), torch.zeros(16, 17, device="cuda")
        calls = {
            "K1": lambda a: asmcheby.fused_asmcheby_pair(
                u, v, a, dx=0.1, dy=0.1, rho=1.0, mu=0.01, alpha=0.7, degree=4,
                bounds_u=(1.0, 0.5, 2.0), bounds_v=(1.0, 0.5, 2.0))[0],
            "K2a": lambda a: strip.strip_down(a, a, st, cfg, True)[0],
            "K2b": lambda a: strip.strip_up(a, a, st, torch.zeros(8, 8, device="cuda"), cfg,
                                            True),
            "K3": lambda a: mg.fused_vcycle(a, a, levels, cfg),
        }
        for name, fn in calls.items():
            with pytest.raises(RuntimeError, match="cannot run under torch.func"):
                torch.func.jvp(fn, (x,), (x,))
