"""The colour-plane fine layout of the PyTorch port against the JAX package.

* ``ops/plane.py``: every function and every ``PlaneStencil5`` plane in
  float64 at 64^2, rel 1e-12 of each output's scale;
* K10 (``ops/plane_strip.py``): the plain versions against the Pallas
  ``plane_strip_down`` / ``plane_strip_up`` in interpret mode at 64^2 in
  float32, at ``tests/test_pallas_plane.py``'s tolerances, alone and in
  that test's two-pass chain;
* ``multigrid_solve(fine_layout='plane')`` composed against the JAX solve
  in float64 (equal cycles, rel 1e-10);
* with the kernel gates forced open, a 64^2 SIMPLE run with the large-grid
  configuration in the plane layout: one K10 down and one up wrapper call
  per step, rel 1e-4 against the JAX package's plane path.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
import naviflow_tpu.ops.pallas_asmcheby as jpa
from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu.algorithms.simple import _build_solve
from naviflow_tpu.ops import pallas_plane as jpp
from naviflow_tpu.ops import plane as jp
from naviflow_tpu.ops.poisson import poisson_coefficients as j_poisson
from naviflow_tpu.ops.stencil9 import apply5 as j_apply5
from naviflow_tpu.ops.stencil9 import from_poisson as j_from_poisson
from naviflow_tpu.solvers import ChebyshevMomentumConfig
from naviflow_tpu.solvers.multigrid import MultigridConfig
from naviflow_tpu.solvers.multigrid import multigrid_solve as j_multigrid_solve

import naviflow_tpu_torch as nt
import naviflow_tpu_torch.solvers.momentum as tmom
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import simple_solve as port_simple_solve
from naviflow_tpu_torch.ops import _cuda, asmcheby, mg, plane_strip, strip
from naviflow_tpu_torch.ops import plane as tp
from naviflow_tpu_torch.solvers.multigrid import multigrid_solve as t_multigrid_solve

torch.set_num_threads(2)
# no TF32 anywhere a float32 product could run (none does on these paths)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NX = 64
CFG = MultigridConfig(pre_smoothing=2, post_smoothing=2, smoother="gs")


def rel_err(got, want):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-300)


def _problem(dtype):
    """test_plane.py's problem: a consistent-variant 64^2 stencil from
    random d-fields, random p, b and a coarse correction."""
    rng = np.random.default_rng(7)
    d_u = rng.uniform(0.5, 1.5, (NX + 1, NX))
    d_v = rng.uniform(0.5, 1.5, (NX, NX + 1))
    p, b = rng.normal(size=(NX, NX)), rng.normal(size=(NX, NX))
    ec = rng.normal(size=(NX // 2, NX // 2))
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    j = [jnp.asarray(a, jdt) for a in (d_u, d_v, p, b, ec)]
    st = j_from_poisson(j_poisson(j[0], j[1], dx=1.0 / NX, dy=1.0 / NX, rho=1.0,
                                  variant="consistent"))
    jax_side = dict(st=st, p=j[2], b=j[3], ec=j[4])
    port_side = dict(st=interop.stencil9(st, dtype=dtype),
                     **{k: interop.tensor(v, dtype=dtype) for k, v in
                        (("p", j[2]), ("b", j[3]), ("ec", j[4]))})
    return jax_side, port_side


@pytest.fixture(scope="module")
def f64():
    return _problem(torch.float64)


@pytest.fixture(scope="module")
def f32():
    return _problem(torch.float32)


def _close_pairs(got, want, rtol=1e-12):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_pairs(g, w, rtol)
        return
    assert rel_err(got, want) <= rtol


_PLANE_OPS = {
    "split_planes": lambda m, s: m.split_planes(s["p"]),
    "merge_planes": lambda m, s: m.merge_planes(*m.split_planes(s["p"])[::-1]),
    "plane_neighbors": lambda m, s: m.plane_neighbors(m.split_planes(s["p"])[1],
                                                      m._row_parity(NX, NX // 2)),
    "plane_neighbors_black": lambda m, s: m.plane_neighbors_black(m.split_planes(s["p"])[0],
                                                                  m._row_parity(NX, NX // 2)),
    "plane_rb_sweep": lambda m, s: m.plane_rb_sweep(*m.split_planes(s["p"]),
                                                    m.PlaneStencil5(s["st"], s["b"])),
    "plane_residual": lambda m, s: m.plane_residual(*m.split_planes(s["p"]),
                                                    m.PlaneStencil5(s["st"], s["b"])),
    "plane_restrict_cc": lambda m, s: m.plane_restrict_cc(*m.split_planes(s["p"])),
    "plane_prolong_cc": lambda m, s: m.plane_prolong_cc(s["ec"]),
    "plane_fine_down": lambda m, s: m.plane_fine_down(*m.split_planes(s["p"]),
                                                      m.PlaneStencil5(s["st"], s["b"]), 2),
    "plane_fine_up": lambda m, s: m.plane_fine_up(*m.split_planes(s["p"]),
                                                  m.PlaneStencil5(s["st"], s["b"]), s["ec"], 1),
    "plane_residual_norm": lambda m, s: m.plane_residual_norm(
        *m.split_planes(s["p"]), m.PlaneStencil5(s["st"], s["b"])),
}


@pytest.mark.parametrize("name", sorted(_PLANE_OPS))
def test_plane_ops_match_jax_f64(f64, name):
    """Each ops/plane.py function at 64^2 in float64, rel 1e-12."""
    j, t = f64
    fn = _PLANE_OPS[name]
    _close_pairs(fn(tp, t), fn(jp, j))


def test_split_merge_roundtrip_and_colours(f64):
    _, t = f64
    R, B = tp.split_planes(t["p"])
    assert torch.equal(tp.merge_planes(R, B), t["p"])
    for i in (0, 1, 5):
        for jc in (0, 1, 7):
            assert R[i, jc] == t["p"][i, 2 * jc + (i % 2)]
            assert B[i, jc] == t["p"][i, 2 * jc + 1 - (i % 2)]


@pytest.mark.parametrize("attr", ["c", "e", "w", "n", "s", "b", "bh", "eh", "wh", "nh",
                                  "sh", "rc_zdiag"])
def test_plane_stencil_planes_match_jax_f64(f64, attr):
    """Each PlaneStencil5 plane (rc_zdiag: the consistent variant's four
    zero-diagonal corner cells) in float64, rel 1e-12."""
    j, t = f64
    want = getattr(jp.PlaneStencil5(j["st"], j["b"]), attr)
    got = getattr(tp.PlaneStencil5(t["st"], t["b"]), attr)
    _close_pairs(got, want)
    if attr == "rc_zdiag":
        assert int(torch.count_nonzero(got)) == 4  # one coarse cell per corner


# ---------------------------------------------------------------------------
# K10: the plain versions against the Pallas kernels (interpret mode)


def _j_cfg(pre, post):
    return dataclasses.replace(CFG, pre_smoothing=pre, post_smoothing=post)


@pytest.mark.parametrize("pre", [1, 2])
def test_plane_strip_down_plain_matches_pallas(f32, pre):
    j, t = f32
    cfg = _j_cfg(pre, pre)
    assert plane_strip.supports_plane_strip(NX, NX // 2, interop.config(cfg), torch.float32)
    assert plane_strip._plane_rows(NX, NX // 2) == jpp._plane_rows(NX, NX // 2)
    jps = jp.PlaneStencil5(j["st"], j["b"])
    want = jpp.plane_strip_down(*jp.split_planes(j["p"]), jps, cfg, interpret=True)
    tps = tp.PlaneStencil5(t["st"], t["b"])
    got = plane_strip.plane_strip_down(*tp.split_planes(t["p"]), tps, interop.config(cfg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("post", [1, 2])
def test_plane_strip_up_plain_matches_pallas(f32, post):
    j, t = f32
    cfg = _j_cfg(post, post)
    jps = jp.PlaneStencil5(j["st"], j["b"])
    want = jpp.plane_strip_up(*jp.split_planes(j["p"]), jps, j["ec"], cfg, interpret=True)
    tps = tp.PlaneStencil5(t["st"], t["b"])
    got = plane_strip.plane_strip_up(*tp.split_planes(t["p"]), tps, t["ec"],
                                     interop.config(cfg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)


def test_plane_strip_plain_chain_matches_pallas(f32):
    """test_pallas_plane.py's two chained down/up passes."""
    j, t = f32
    jps = jp.PlaneStencil5(j["st"], j["b"])
    tps = tp.PlaneStencil5(t["st"], t["b"])
    tcfg = interop.config(CFG)
    Rj, Bj = jp.split_planes(j["p"])
    Rt, Bt = tp.split_planes(t["p"])
    for _ in range(2):
        Rj, Bj, rcj = jpp.plane_strip_down(Rj, Bj, jps, CFG, interpret=True)
        Rt, Bt, rct = plane_strip.plane_strip_down_plain(Rt, Bt, tps, tcfg)
        np.testing.assert_allclose(rct.numpy(), np.asarray(rcj), rtol=1e-4, atol=1e-3)
        Rj, Bj = jpp.plane_strip_up(Rj, Bj, jps, j["ec"], CFG, interpret=True)
        Rt, Bt = plane_strip.plane_strip_up_plain(Rt, Bt, tps, t["ec"], tcfg)
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), rtol=1e-4, atol=1e-3)


def test_plane_strip_gate_matches_reference():
    """The port's gate and strip height are the reference's, at the
    sizes the two layouts are measured at and at the refused edges."""
    for m, nc in ((64, 32), (1024, 512), (2048, 1024), (4096, 2048), (8192, 4096), (32, 16)):
        assert plane_strip._plane_rows(m, nc) == jpp._plane_rows(m, nc), (m, nc)
    tcfg = interop.config(CFG)
    assert plane_strip.supports_plane_strip(4096, 2048, tcfg, torch.float32)
    assert not plane_strip.supports_plane_strip(4096, 2048, tcfg, torch.float64)
    for bad in (dict(pre_smoothing=3), dict(omega=1.2), dict(restriction="inject")):
        assert not plane_strip.supports_plane_strip(
            64, 32, dataclasses.replace(tcfg, **bad), torch.float32)


# ---------------------------------------------------------------------------
# the plane layout through multigrid_solve


def _smooth_problem():
    """test_plane.py's manufactured problem: smooth d-fields and a
    compatible right-hand side b = A x_true, float64."""
    iu = np.arange(NX + 1)[:, None] / NX
    ju = np.arange(NX)[None, :] / NX
    d_u = 1.0 + 0.4 * np.sin(2 * np.pi * iu) * np.cos(2 * np.pi * ju)
    iv = np.arange(NX)[:, None] / NX
    jv = np.arange(NX + 1)[None, :] / NX
    d_v = 1.0 + 0.4 * np.cos(2 * np.pi * iv) * np.sin(2 * np.pi * jv)
    x_true = np.random.default_rng(12).normal(size=(NX, NX))
    st = j_from_poisson(j_poisson(jnp.asarray(d_u), jnp.asarray(d_v), dx=1.0 / NX,
                                  dy=1.0 / NX, rho=1.0, variant="consistent"))
    b = np.asarray(j_apply5(jnp.asarray(x_true), st))
    return d_u, d_v, b


def test_plane_solve_matches_jax_f64():
    """multigrid_solve with fine_layout='plane', composed, against the JAX
    plane solve: equal cycle counts and rel 1e-10 in float64."""
    d_u, d_v, b = _smooth_problem()
    cfg = MultigridConfig(tolerance=1e-5, max_cycles=60, check_every=2, pre_smoothing=2,
                          post_smoothing=2, smoother="gs", backend="xla", fine_layout="plane")
    kw = dict(dx=1.0 / NX, dy=1.0 / NX, rho=1.0)
    jpres, jinfo = j_multigrid_solve(jnp.asarray(b), jnp.asarray(d_u), jnp.asarray(d_v),
                                     jnp.zeros((NX, NX)), cfg, **kw)
    T = lambda x: interop.tensor(x, dtype=torch.float64)  # noqa: E731
    tpres, tinfo = t_multigrid_solve(T(b), T(d_u), T(d_v), torch.zeros((NX, NX), dtype=torch.float64),
                                     interop.config(cfg), **kw)
    assert tinfo.iterations == int(jinfo.iterations)
    assert float(tinfo.rel_residual) < 1e-5
    assert rel_err(tpres, jpres) < 1e-10
    # the residuals are ~1e-5 of b: held to 1e-10 of b's scale
    assert abs(float(tinfo.rel_residual) - float(jinfo.rel_residual)) <= 1e-10
    r_err = float(np.max(np.abs(tinfo.residual_field.numpy() - np.asarray(jinfo.residual_field))))
    assert r_err <= 1e-10 * float(np.max(np.abs(b)))


def test_plane_solve_follows_interleaved():
    """The plane layout is the interleaved solve re-associated: the same
    cycle count on the port's composed path, solutions within test_plane.py's
    2e-3 of scale (f32)."""
    d_u, d_v, b = _smooth_problem()
    T = lambda x: interop.tensor(x, dtype=torch.float32)  # noqa: E731
    base = interop.config(MultigridConfig(tolerance=1e-5, max_cycles=60, check_every=2,
                                          backend="xla"))
    kw = dict(dx=1.0 / NX, dy=1.0 / NX, rho=1.0)
    p_i, info_i = t_multigrid_solve(T(b), T(d_u), T(d_v), torch.zeros(NX, NX), base, **kw)
    p_p, info_p = t_multigrid_solve(T(b), T(d_u), T(d_v), torch.zeros(NX, NX),
                                    dataclasses.replace(base, fine_layout="plane"), **kw)
    assert info_i.iterations == info_p.iterations
    assert float(info_p.rel_residual) < 1e-5
    assert float((p_p - p_i).abs().max()) < 2e-3 * float(p_i.abs().max())


# ---------------------------------------------------------------------------
# the SIMPLE path with the kernel gates forced open

MOM = ChebyshevMomentumConfig(degree=4)
PRES = MultigridConfig(tolerance=0.0, max_cycles=1, cycle_type="v", pre_smoothing=1,
                       post_smoothing=1, coarsest_sweeps=32, coarse_rebuild_every=8,
                       fine_layout="plane")


@pytest.fixture
def plane_gates_open(monkeypatch):
    """Treat CPU tensors as kernel-capable, admit K1 at any size, and shrink
    the fused V-cycle's budget so that at 64^2 the hierarchy below the plane
    level (32^2 -> 4^2) is one fused tail, as the 4096^2 plane path runs its
    K2 levels and K3 tail below K10; count the plain versions' calls."""
    monkeypatch.setattr(_cuda, "kernel_device", lambda x: True)
    monkeypatch.setattr(tmom, "supports_asmcheby", lambda *a: True)
    monkeypatch.setattr(mg, "VMEM_BUDGET_BYTES", 400_000)
    calls = {}

    def count(module, name):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    for module, name in ((asmcheby, "fused_asmcheby_pair_plain"),
                         (plane_strip, "plane_strip_down_plain"),
                         (plane_strip, "plane_strip_up_plain"),
                         (strip, "strip_down_plain"), (strip, "strip_up_plain"),
                         (mg, "fused_vcycle_plain"), (mg, "fused_mg_solve_plain")):
        count(module, name)
    return calls


def test_forced_plane_path_matches_jax(plane_gates_open, monkeypatch):
    """4 steps at 64^2 in float32 with the large-grid configuration and
    fine_layout='plane': one K10 down and up and one K3 call per step,
    rel 1e-4 against the JAX package's plane path (its merged momentum
    kernel forced, interpret mode)."""
    n, steps = 64, 4
    mesh = nf.StructuredMesh(nx=n, ny=n)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    cfg = SIMPLEConfig(max_iterations=steps, tolerance=0.0)

    monkeypatch.setattr(jpa, "supports_asmcheby", lambda *a: True)
    real = jpa.fused_asmcheby_pair
    monkeypatch.setattr(jpa, "fused_asmcheby_pair",
                        lambda *a, **k: real(*a, **{**k, "interpret": True}))
    # the JAX package's _build_solve cache key has neither dtype nor gate state
    _build_solve.cache_clear()
    try:
        js, jd = simple_solve(mesh, fluid, bc, nf.initialize_state(mesh, bc, dtype=jnp.float32),
                              cfg, momentum=MOM, pressure=PRES, loop="fused")
        js = {k: np.asarray(getattr(js, k)) for k in ("u", "v", "p")}
        j_hist = np.asarray(jd.u_res_history)
    finally:
        _build_solve.cache_clear()

    tmesh, tbc = interop.mesh(mesh), interop.boundary_conditions(bc)
    state0 = nt.initialize_state(tmesh, tbc, dtype=torch.float32, device="cpu")
    ts, td = port_simple_solve(tmesh, interop.fluid(fluid), tbc, state0, interop.config(cfg),
                               momentum=interop.config(MOM), pressure=interop.config(PRES))
    assert plane_gates_open == {"fused_asmcheby_pair_plain": steps,
                                "plane_strip_down_plain": steps,
                                "plane_strip_up_plain": steps,
                                "fused_vcycle_plain": steps}
    for name in ("u", "v", "p"):
        got, want = getattr(ts, name).numpy(), js[name]
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-4, name
    np.testing.assert_allclose(td.u_res_history.numpy(), j_hist, rtol=1e-4)
