"""The port's multigrid debug recorder (``naviflow_tpu_torch/utils/mg_debug.py``).

``debug_vcycle`` is bit-equal to the port's composed ``multigrid._cycle``
(V and W cycles; a 31^2 vertex and a 32^2 cell-centred hierarchy; float32
and float64) and records 6 stages per non-coarsest level plus the
coarsest solve; at float64 each stage agrees with the JAX package's
``debug_vcycle`` to rel 1e-12 under the same title; the PDF has one page a
stage a cycle (as ``tests/test_mg_debug.py`` holds the JAX recorder).
"""

import numpy as np
import pytest
import torch

from naviflow_tpu_torch.solvers.multigrid import MultigridConfig, _cycle, build_levels
from naviflow_tpu_torch.utils.mg_debug import debug_vcycle, dump_vcycle_pdf

STAGE_REL = 1e-12


def _inputs(n, seed=3):
    """Seeded positive d coefficients and a right-hand side of an n^2 grid."""
    rng = np.random.default_rng(seed)
    d_u = rng.random((n + 1, n)) * 0.02 + 0.01
    d_v = rng.random((n, n + 1)) * 0.02 + 0.01
    b = rng.standard_normal((n, n))
    return d_u, d_v, b - b.mean(), 1.0 / (n - 1)


def _port_problem(n, cycle_type, dtype):
    d_u, d_v, b, h = _inputs(n)
    cfg = MultigridConfig(cycle_type=cycle_type)
    levels = build_levels(torch.as_tensor(d_u, dtype=dtype), torch.as_tensor(d_v, dtype=dtype),
                          cfg, dx=h, dy=h, rho=1.0, variant="consistent")
    return levels, torch.as_tensor(b, dtype=dtype), cfg


CASES = [(n, c, d) for n in (31, 32) for c in ("v", "w")
         for d in (torch.float32, torch.float64)]


@pytest.mark.parametrize("n,cycle_type,dtype", CASES,
                         ids=[f"{n}-{c}-{str(d)[6:]}" for n, c, d in CASES])
def test_debug_vcycle_bit_equal_to_cycle(n, cycle_type, dtype):
    levels, b, cfg = _port_problem(n, cycle_type, dtype)
    assert len(levels) >= 3
    p0 = torch.zeros_like(b)
    want = _cycle(p0, b, levels, 0, cfg)
    got, stages = debug_vcycle(p0, b, levels, cfg)
    assert got.dtype == dtype and torch.equal(got, want)
    n_levels = len(levels)
    # a W cycle visits each level below the finest twice per visit of the
    # level above it, down to (and not repeating) the coarsest
    visits = ([1] + [2 ** min(lvl, n_levels - 2) for lvl in range(1, n_levels)]
              if cycle_type == "w" else [1] * n_levels)
    assert len(stages) == 6 * sum(visits[:-1]) + visits[-1]
    assert "pre-smoothing" in stages[0][0] and "post-smoothing" in stages[-1][0]
    if cycle_type == "v":
        assert "coarsest" in stages[3 * (n_levels - 1)][0]
    assert torch.equal(stages[-1][1], got)


@pytest.mark.parametrize("n,cycle_type", [(31, "v"), (32, "v"), (31, "w")])
def test_stages_match_jax(n, cycle_type):
    import jax.numpy as jnp

    from naviflow_tpu.solvers.multigrid import MultigridConfig as JaxConfig
    from naviflow_tpu.solvers.multigrid import build_levels as jax_build_levels
    from naviflow_tpu.utils.mg_debug import debug_vcycle as jax_debug_vcycle

    levels, b, cfg = _port_problem(n, cycle_type, torch.float64)
    d_u, d_v, bn, h = _inputs(n)
    jcfg = JaxConfig(cycle_type=cycle_type)
    jlevels = jax_build_levels(jnp.asarray(d_u), jnp.asarray(d_v), jcfg, dx=h, dy=h, rho=1.0,
                               variant="consistent")
    p, stages = debug_vcycle(torch.zeros_like(b), b, levels, cfg)
    jp, jstages = jax_debug_vcycle(jnp.zeros_like(jnp.asarray(bn)), jnp.asarray(bn), jlevels,
                                   jcfg)
    assert [t for t, _ in stages] == [t for t, _ in jstages]
    for (title, got), (_, want) in zip(stages, jstages):
        want = np.asarray(want)
        assert got.shape == want.shape, title
        gap = np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want))
        assert gap <= STAGE_REL, (title, gap)


def test_dump_vcycle_pdf_writes_pages(tmp_path):
    levels, b, cfg = _port_problem(31, "v", torch.float64)
    path = tmp_path / "mg_debug.pdf"
    p, n_pages = dump_vcycle_pdf(path, torch.zeros_like(b), b, levels, cfg, n_cycles=2)
    assert path.exists() and path.stat().st_size > 1000
    assert n_pages == 2 * (6 * (len(levels) - 1) + 1)
    once = _cycle(torch.zeros_like(b), b, levels, 0, cfg)
    assert torch.equal(p, _cycle(once, b, levels, 0, cfg))
