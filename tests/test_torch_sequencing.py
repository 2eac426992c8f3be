"""The port's grid sequencing and Reynolds continuation
(``algorithms/sequencing.py``) against the JAX package's on the CPU
(float64): the ladder, the staggered warm-start interpolation, and
``grid_sequence_solve``, ``reynolds_continuation_solve`` and
``sequenced_continuation_solve`` level by level."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu.algorithms import sequencing as jseq
from naviflow_tpu.solvers import JacobiMomentumConfig, MultigridConfig

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import sequencing as tseq
from naviflow_tpu_torch.algorithms import simple_solve as t_simple_solve

torch.set_num_threads(2)

CFG = SIMPLEConfig(max_iterations=300, tolerance=2e-3)
PRES = MultigridConfig(tolerance=1e-2, max_cycles=6, check_every=2, coarsest_sweeps=8,
                       coarsest_grid_size=8)


def rel_err(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))


def t_solve(mesh, fluid, bc, state, cfg, *, momentum, pressure, loop):
    """The port's ``simple_solve`` with JAX configs converted, so both
    packages' sequencing functions get the same arguments."""
    return t_simple_solve(mesh, fluid, bc, state, interop.config(cfg),
                          momentum=interop.config(momentum),
                          pressure=interop.config(pressure), loop=loop)


def assert_same_levels(jres, tres, rtol=1e-9):
    (js, jd, jsum), (ts, td, tsum) = jres, tres
    assert_summaries_close(tsum, jsum)
    assert td.iterations == int(jd.iterations)
    for name in ("u", "v", "p"):
        assert rel_err(getattr(ts, name), getattr(js, name)) < rtol, name


def assert_summaries_close(tsum, jsum):
    """Per-level summaries: equal keys, iterations and flags; residuals to
    1e-9."""
    assert len(tsum) == len(jsum)
    for t, j in zip(tsum, jsum):
        assert t.keys() == j.keys()
        for k in t:
            if k == "continuation":
                assert_summaries_close(t[k], j[k])
            elif k == "final_residual":
                assert abs(t[k] - j[k]) <= 1e-9 * abs(j[k])
            else:
                assert t[k] == j[k], (k, t[k], j[k])


def test_ladder_and_coarsen_size_match_jax():
    for nx in range(1, 2100):
        assert tseq.coarsen_size(nx) == jseq.coarsen_size(nx)
    for nx in list(range(1, 300)) + [511, 512, 1023, 1024, 2047, 2048, 4096]:
        for coarsest in (1, 7, 15, 16, 31, 32, 63):
            for levels in (1, 3, 6, 9):
                assert (tseq.build_ladder(nx, coarsest=coarsest, max_levels=levels)
                        == jseq.build_ladder(nx, coarsest=coarsest, max_levels=levels))
    assert tseq.build_ladder(1024) == [1024, 512, 256, 128, 64, 32]


@pytest.mark.parametrize("coarse,fine", [((16, 16), (32, 32)), ((15, 15), (31, 31)),
                                         ((31, 31), (63, 63)), ((8, 16), (16, 32)),
                                         ((17, 16), (33, 32)), ((128, 128), (256, 256))])
def test_prolong_state_matches_jax(coarse, fine):
    """Bilinear staggered warm start (u, v, p each) and the velocity BCs,
    to 1e-12 of the JAX package's ``jax.image.resize``."""
    rng = np.random.default_rng(sum(coarse))
    cm = nf.StructuredMesh(nx=coarse[0], ny=coarse[1])
    fm = nf.StructuredMesh(nx=fine[0], ny=fine[1])
    bc = nf.lid_driven_cavity(1.0)
    fields = {k: rng.normal(size=getattr(cm, f"{k}_shape")) for k in ("u", "v", "p")}
    want = jseq.prolong_state(nf.FlowState(**{k: jnp.asarray(v) for k, v in fields.items()}),
                              fm, bc)
    got = tseq.prolong_state(nt.FlowState(**{k: torch.as_tensor(v) for k, v in fields.items()}),
                             interop.mesh(fm), interop.boundary_conditions(bc))
    for k in ("u", "v", "p"):
        assert getattr(got, k).shape == getattr(fm, f"{k}_shape")
        assert rel_err(getattr(got, k), getattr(want, k)) < 1e-12, k


@pytest.mark.parametrize("n,coarsest", [(32, 16), (31, 15)])
@pytest.mark.parametrize("lite", [False, True])
def test_grid_sequence_solve_matches_jax(n, coarsest, lite):
    """Two-level ladders (16 -> 32, 15 -> 31) at Re=100, with and without
    a lighter fine-level momentum: per-level summaries equal, fields to
    1e-9."""
    mesh = nf.StructuredMesh(nx=n, ny=n)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=100)
    bc = nf.lid_driven_cavity(1.0)
    mom = JacobiMomentumConfig(n_sweeps=2)
    plm = (lambda nx: JacobiMomentumConfig(n_sweeps=1) if nx == n else mom) if lite else None
    kw = dict(momentum=mom, pressure=PRES, loop="fused", coarsest=coarsest,
              per_level_momentum=plm)
    jres = jseq.grid_sequence_solve(mesh, fluid, bc, simple_solve, CFG, dtype=jnp.float64,
                                    **kw)
    tres = tseq.grid_sequence_solve(interop.mesh(mesh), interop.fluid(fluid),
                                    interop.boundary_conditions(bc), t_solve, CFG,
                                    dtype=torch.float64, device="cpu", **kw)
    assert [s["nx"] for s in tres[2]] == [coarsest, n]
    assert all(s["converged"] for s in tres[2])
    assert_same_levels(jres, tres)


def test_reynolds_continuation_matches_jax():
    """Re 100 -> 400 at 16^2 from a given state: per-Re summaries equal,
    fields to 1e-9."""
    mesh = nf.StructuredMesh(nx=16, ny=16)
    bc = nf.lid_driven_cavity(1.0)
    kw = dict(momentum=JacobiMomentumConfig(), pressure=PRES, loop="fused")
    jres = jseq.reynolds_continuation_solve(
        mesh, [100, 400], bc, simple_solve, CFG,
        state=nf.initialize_state(mesh, bc, dtype=jnp.float64), **kw)
    tmesh, tbc = interop.mesh(mesh), interop.boundary_conditions(bc)
    tres = tseq.reynolds_continuation_solve(
        tmesh, [100, 400], tbc, t_solve, CFG,
        state=nt.initialize_state(tmesh, tbc, dtype=torch.float64, device="cpu"), **kw)
    assert [s["reynolds"] for s in tres[2]] == [100, 400]
    assert_same_levels(jres, tres)


def test_sequenced_continuation_matches_jax():
    """The schedule [100, 400] walked at 16^2, then 32^2 at Re=400 from the
    prolonged state: per-level summaries equal, fields to 1e-9."""
    mesh = nf.StructuredMesh(nx=32, ny=32)
    bc = nf.lid_driven_cavity(1.0)
    kw = dict(momentum=JacobiMomentumConfig(), pressure=PRES, loop="chunked:20", coarsest=16)
    jres = jseq.sequenced_continuation_solve(mesh, [100, 400], bc, simple_solve, CFG,
                                             dtype=jnp.float64, **kw)
    tres = tseq.sequenced_continuation_solve(interop.mesh(mesh), [100, 400],
                                             interop.boundary_conditions(bc), t_solve, CFG,
                                             dtype=torch.float64, device="cpu", **kw)
    assert tres[2][0]["nx"] == 16 and [s["reynolds"] for s in tres[2][0]["continuation"]] == [
        100, 400]
    assert tres[2][1]["nx"] == 32 and tres[2][1]["reynolds"] == 400
    assert_same_levels(jres, tres)


def test_perturb_seed_is_seeded_noise():
    """``perturb_seed`` adds the same O(1e-7) pressure noise for the same
    seed (a torch generator, not the JAX package's bits); no card is
    needed on the CPU."""
    mesh = nt.StructuredMesh(nx=8, ny=8)
    bc = nt.lid_driven_cavity(1.0)
    seen = []

    def capture(mesh, fluid, bc, state, cfg, **kw):
        seen.append(state.p.clone())
        return state, type("D", (), dict(iterations=0, converged=True, final_residual=0.0))()

    for seed in (3, 3, 4):
        tseq.grid_sequence_solve(mesh, nt.FluidProperties(reynolds_number=10), bc, capture,
                                 None, momentum=None, pressure=None, coarsest=8,
                                 device="cpu", perturb_seed=seed)
    assert torch.equal(seen[0], seen[1]) and not torch.equal(seen[0], seen[2])
    assert 0 < float(seen[0].max()) <= 1e-7 and float(seen[0].min()) >= 0
