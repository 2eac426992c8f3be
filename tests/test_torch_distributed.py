"""The port's distributed SIMPLE / SIMPLEC / PISO (``parallel/dist_simple.py``)
on meshes of gloo ranks, on the CPU (f64).

* Every algorithm with every momentum kind (Jacobi, Chebyshev, BiCGSTAB
  stopping early at its tolerance) and every pressure solver (Jacobi-PCG,
  Chebyshev-PCG, RBGS, MGCG, MG, FMG), and the 9-point QUICK scheme, on a
  2x2 mesh at 16^2 against the JAX package's ``distributed_simple_solve``
  on a (2, 2) device mesh: every step's residual and the fields at rel
  1e-10; the state the same bits on every rank; the pressure iterations of
  every step equal to the same run on one rank.  The multigrid cases
  (``MG_CASES``: MGCG, MG, FMG) run on a 2x2 spawn of their own in
  ``tests/test_torch_distributed_mg.py``, so that the test workers share
  the spawns.
* The chunked loop against the per-step loop.
* Distributed QUICK against the single-device QUICK solve.
* (``tests/test_torch_distributed_1x4.py``, a file of its own so that the
  test workers share the spawns: a padded 30^2 grid on a 1x4 mesh; and
  ``tests/test_torch_distributed_mg.py``: the duplicated shared faces
  bit-equal across neighbours after 10 steps, on the multigrid cases'
  spawn.)
* Whether the single-device SIMPLE with Chebyshev momentum of degree 6 and
  MGCG pressure runs the distributed Chebyshev + MGCG algorithm (64^2, one
  rank): it does, to rounding, so the card's 1024^2 distributed run is
  held to the single-device run.

The rank bodies run in spawned processes (``tests/torch_ranks.py``), which
import this module: it imports JAX only inside test functions.
"""

import numpy as np
import pytest
import torch

import naviflow_tpu_torch as nt
from naviflow_tpu_torch.parallel.dist_simple import (DistributedConfig, aux_init,
                                                     distributed_simple_solve,
                                                     make_distributed_step)
from naviflow_tpu_torch.parallel import decompose as d
from naviflow_tpu_torch.parallel.sharding import make_device_mesh
from torch_ranks import start_ranks

torch.set_num_threads(2)

N = 16
STEPS = 5
# the gather cutoff at 4: the 16^2 multigrid keeps 16^2 and 8^2 on the mesh
BASE = dict(max_iterations=STEPS, tolerance=0.0, check_every=1, pressure_tol=1e-8,
            pressure_max_iter=200, gather_cutoff=4)
CASES = {
    "simple-jacobi-chebcg": dict(),
    "simple-jacobi-cg": dict(pressure_solver="cg"),
    "simple-chebyshev-mgcg": dict(momentum_solver="chebyshev", pressure_solver="mgcg"),
    "simple-bicgstab-cg": dict(momentum_solver="bicgstab", momentum_tol=1e-6,
                               momentum_max_iter=40, pressure_solver="cg"),
    "simple-jacobi-fmg": dict(pressure_solver="fmg", pressure_max_iter=4),
    "simplec-jacobi-rbgs": dict(algorithm="simplec", pressure_solver="rbgs",
                                pressure_max_iter=60),
    "simplec-chebyshev-cg": dict(algorithm="simplec", momentum_solver="chebyshev",
                                 pressure_solver="cg"),
    "piso-jacobi-mg": dict(algorithm="piso", pressure_solver="mg", pressure_max_iter=6),
    "piso-bicgstab-chebcg": dict(algorithm="piso", momentum_solver="bicgstab",
                                 momentum_tol=1e-6, momentum_max_iter=40),
    "simple-quick-cg": dict(scheme="quick", pressure_solver="cg"),
}
# the multigrid pressure cases, on their own spawn
# (tests/test_torch_distributed_mg.py); the rest run on this file's
MG_CASES = ("simple-chebyshev-mgcg", "simple-jacobi-fmg", "piso-jacobi-mg")
HERE = {name: kw for name, kw in CASES.items() if name not in MG_CASES}
PADDED = {
    "padded-jacobi-cg": dict(pressure_solver="cg"),
    "padded-jacobi-mgcg": dict(pressure_solver="mgcg"),
}
SHARED_FACES = {"power_law": dict(pressure_solver="cg"),
                "quick-bicgstab": dict(scheme="quick", momentum_solver="bicgstab",
                                       pressure_solver="mgcg")}


def _case(n):
    return (nt.StructuredMesh(nx=n, ny=n), nt.FluidProperties(density=1.0, reynolds_number=100),
            nt.lid_driven_cavity(1.0))


def _solve(rm, n, kw, loop="per-step", steps=STEPS):
    mesh, fluid, bc = _case(n)
    cfg = DistributedConfig(**dict(BASE, **kw, max_iterations=steps))
    state = nt.initialize_state(mesh, bc, dtype=torch.float64, device="cpu")
    s, diag = distributed_simple_solve(mesh, fluid, bc, state, rm, cfg, loop=loop)
    return dict(u=s.u, v=s.v, p=s.p, diag=diag)


def _runs_body(rm, n, cases, chunked):
    out = {name: _solve(rm, n, kw) for name, kw in cases.items()}
    for name in chunked:
        out[name + ":chunked"] = _solve(rm, n, dict(cases[name], check_every=4), "chunked",
                                        steps=10)
        out[name + ":per-step10"] = _solve(rm, n, dict(cases[name], check_every=4), steps=10)
    return out


def _faces_body(rm, n, steps):
    """``steps`` distributed steps from rest; this rank's final blocks."""
    mesh, fluid, bc = _case(n)
    mx, my = rm.shape
    dec = d.Decomp(nx=n, ny=n, mx=mx, my=my)
    state = nt.initialize_state(mesh, bc, dtype=torch.float64, device="cpu")
    out = {}
    for name, kw in SHARED_FACES.items():
        cfg = DistributedConfig(**dict(BASE, **kw))
        dx, dy = mesh.get_cell_sizes()
        step = make_distributed_step(rm, dec, bc, cfg, dx=dx, dy=dy, rho=1.0,
                                     mu=fluid.get_viscosity())
        u = d.block(d.to_blocked_u(state.u, mx, my), rm)
        v = d.block(d.to_blocked_v(state.v, my, mx), rm)
        p = d.block(d.to_blocked_p(state.p, mx, my), rm)
        aux = aux_init(cfg, torch.float64)
        for _ in range(steps):
            u, v, p, *rest = step(u, v, p, *aux)
            aux = tuple(rest[:-2])
        out[name] = (u, v, (rm.bx, rm.by))
    return out


def _mg_body(rm, n, cases, faces_steps):
    """``_runs_body`` of ``cases`` and ``_faces_body`` of ``faces_steps``
    steps on one spawn (``tests/test_torch_distributed_mg.py``)."""
    return dict(runs=_runs_body(rm, n, cases, []), faces=_faces_body(rm, n, faces_steps))


def one_rank_runs(cases):
    """Each of ``cases`` on one rank (no group)."""
    rm = make_device_mesh(device="cpu")
    return {name: _solve(rm, N, CASES[name]) for name in cases}


def references_while(ranks, cases, n, shape, one_rank=False):
    """While ``ranks`` (``torch_ranks.start_ranks``) run: the JAX package's
    run of each of ``cases`` (name -> config) on a ``shape`` device mesh
    and, with ``one_rank``, each case on one rank of the port; then the
    ranks' results.  Returns (the ranks' results in rank order, {name: JAX
    run}, {name: one-rank run})."""
    try:
        jax_runs = {name: _jax_run(n, kw, shape) for name, kw in cases.items()}
        single = one_rank_runs(cases) if one_rank else {}
    finally:
        results = ranks.join()
    return results, jax_runs, single


@pytest.fixture(scope="module")
def runs22(tmp_path_factory):
    """This file's cases on one 2x2 spawn, the JAX package's runs and the
    one-rank runs computed while the ranks run (``references_while``)."""
    ranks = start_ranks(_runs_body, (2, 2), tmp_path_factory.mktemp("mesh22"), N, HERE,
                        ["simple-bicgstab-cg"], timeout=400)
    return references_while(ranks, HERE, N, (2, 2), one_rank=True)


@pytest.fixture(scope="module")
def mesh22(runs22):
    """The ranks' results, rank order."""
    return runs22[0]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))


def _jax_run(n, kw, shape):
    import jax.numpy as jnp

    import naviflow_tpu as nf
    from naviflow_tpu.parallel.dist_simple import DistributedConfig as JDC
    from naviflow_tpu.parallel.dist_simple import distributed_simple_solve as jsolve
    from naviflow_tpu.parallel.sharding import make_device_mesh as jmesh

    mesh = nf.StructuredMesh(nx=n, ny=n)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    return jsolve(mesh, fluid, bc, nf.initialize_state(mesh, bc, dtype=jnp.float64),
                  jmesh(shape[0] * shape[1], shape=shape), JDC(**dict(BASE, **kw)),
                  loop="per-step")


def _held_to_jax(ranks, name, jax_run):
    js, jd = jax_run
    got = ranks[0][name]
    steps = np.asarray(got["diag"]["step_residuals"])
    want = np.asarray(jd["residual_history"])  # check_every=1: one entry a step
    assert steps.shape == want.shape == (STEPS,)
    assert np.max(np.abs(steps - want) / want) < 1e-10, (steps, want)
    for k in ("u", "v", "p"):
        assert _rel(got[k].numpy(), getattr(js, k)) < 1e-10, k
    for r in ranks[1:]:  # the global state is the same bits on every rank
        for k in ("u", "v", "p"):
            assert torch.equal(r[name][k], got[k])
        assert r[name]["diag"] == got["diag"]
    return got


@pytest.mark.parametrize("name", list(HERE))
def test_distributed_matches_jax_2x2(name, runs22):
    ranks, jax_runs, one_rank = runs22
    got = _held_to_jax(ranks, name, jax_runs[name])
    assert got["diag"]["inner_iterations"] == one_rank[name]["diag"]["inner_iterations"]
    assert len(got["diag"]["inner_iterations"]) == STEPS


def _chunked_matches_per_step(res, name):
    ch, ps = res[name + ":chunked"]["diag"], res[name + ":per-step10"]["diag"]
    assert ch["iterations"] == 12 and ps["iterations"] == 10
    assert ch["step_residuals"][:10] == ps["step_residuals"]
    assert ch["inner_iterations"][:10] == ps["inner_iterations"]
    assert len(ch["residual_history"]) == 3 and len(ps["residual_history"]) == 3


@pytest.mark.parametrize("fixture,name", [("mesh22", "simple-bicgstab-cg")])
def test_chunked_loop_matches_per_step(fixture, name, request):
    """10 steps in chunks of 4 (the chunked loop runs on to 12, as the JAX
    package's does) against 10 single steps: the first 10 steps' residuals
    and pressure iterations identical (the 1x4 mesh's case:
    ``tests/test_torch_distributed_1x4.py``)."""
    _chunked_matches_per_step(request.getfixturevalue(fixture)[0], name)


def test_distributed_quick_matches_single_device(mesh22):
    """The 2x2 QUICK run against the port's single-device QUICK SIMPLE with
    the same Jacobi momentum and Jacobi-PCG pressure: every step's residual
    and the fields at rel 1e-9, the same pressure iterations."""
    from naviflow_tpu_torch.algorithms import SIMPLEConfig, simple_solve
    from naviflow_tpu_torch.solvers import CGPressureConfig, JacobiMomentumConfig

    mesh, fluid, bc = _case(N)
    s, diag = simple_solve(mesh, fluid, bc,
                           nt.initialize_state(mesh, bc, dtype=torch.float64, device="cpu"),
                           SIMPLEConfig(max_iterations=STEPS, tolerance=0.0),
                           momentum=JacobiMomentumConfig(n_sweeps=2, scheme="quick"),
                           pressure=CGPressureConfig(tolerance=1e-8, max_iterations=200))
    got = mesh22[0]["simple-quick-cg"]
    want = diag.total_res_history.numpy()[:STEPS]
    assert np.max(np.abs(np.asarray(got["diag"]["step_residuals"]) - want) / want) < 1e-9
    for k in ("u", "v", "p"):
        assert _rel(got[k].numpy(), getattr(s, k).numpy()) < 1e-9, k
    assert got["diag"]["inner_iterations"] == diag.inner_iters_history.numpy()[:STEPS].tolist()


def test_single_device_mgcg_simple_is_the_distributed_algorithm():
    """64^2, 10 steps from rest on one rank: the distributed SIMPLE with
    Chebyshev momentum (degree 6) and MGCG pressure (one V-cycle, 2/2 GS,
    32 coarsest sweeps, gather cutoff 32) against the single-device SIMPLE
    with ``ChebyshevMomentumConfig(degree=6)`` and that ``MGCGPressureConfig``:
    the same algorithm, every step's residual and the fields to 1e-12 and
    the same CG iterations."""
    from naviflow_tpu_torch.algorithms import SIMPLEConfig, simple_solve
    from naviflow_tpu_torch.solvers import (ChebyshevMomentumConfig, MGCGPressureConfig,
                                            MultigridConfig)

    n, steps = 64, 10
    mesh, fluid, bc = _case(n)
    fd, dd = distributed_simple_solve(
        mesh, fluid, bc, nt.initialize_state(mesh, bc, dtype=torch.float64, device="cpu"),
        make_device_mesh(device="cpu"),
        DistributedConfig(max_iterations=steps, tolerance=0.0, momentum_solver="chebyshev",
                          pressure_solver="mgcg", pressure_tol=1e-6, pressure_max_iter=60,
                          gather_cutoff=32, check_every=steps))
    fs, ds = simple_solve(
        mesh, fluid, bc, nt.initialize_state(mesh, bc, dtype=torch.float64, device="cpu"),
        SIMPLEConfig(max_iterations=steps, tolerance=0.0),
        momentum=ChebyshevMomentumConfig(degree=6),
        pressure=MGCGPressureConfig(tolerance=1e-6, max_iterations=60, mg=MultigridConfig(
            pre_smoothing=2, post_smoothing=2, coarsest_sweeps=32)))
    want = ds.total_res_history.numpy()[:steps]
    assert np.max(np.abs(np.asarray(dd["step_residuals"]) - want) / want) < 1e-12
    for k in ("u", "v", "p"):
        assert _rel(getattr(fd, k).numpy(), getattr(fs, k).numpy()) < 1e-12, k
    assert dd["inner_iterations"] == ds.inner_iters_history.numpy()[:steps].tolist()


def test_interop_distributed_config():
    """``interop.config`` maps the JAX ``DistributedConfig`` onto the port's:
    the same fields and defaults."""
    import dataclasses

    from naviflow_tpu.parallel.dist_simple import DistributedConfig as JDC

    from naviflow_tpu_torch import interop

    assert [f.name for f in dataclasses.fields(JDC)] == [
        f.name for f in dataclasses.fields(DistributedConfig)]
    assert interop.config(JDC()) == DistributedConfig()
    for kw in CASES.values():
        assert interop.config(JDC(**dict(BASE, **kw))) == DistributedConfig(**dict(BASE, **kw))
