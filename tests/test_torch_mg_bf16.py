"""The port's bfloat16 multigrid smoother (``smoother_dtype='bfloat16'``,
the error form) against the JAX package on the CPU, in float32: the solve's
convergence and cycles against the JAX package's, and one smoothing call
against the float32 error-form sweeps.  (The other variants:
``tests/test_torch_mg_variants.py``, whose system and levels these reuse; a
file of its own so that the test workers share the long runs.)"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naviflow_tpu.solvers import multigrid as jmg
from naviflow_tpu.solvers.multigrid import MultigridConfig as JMG

from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops import stencil9 as tst9
from naviflow_tpu_torch.solvers import multigrid as tmg

from test_torch_mg_variants import T, both_levels, rel_err, system

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [31, 32])
def test_bf16_smoothing_converges_like_jax(n):
    """The error-form bfloat16 smoother in float32, held to the JAX
    package's own bf16 rule (``tests/test_transfer_multigrid.py``): to 1e-4
    within the float32 cycle count + 2.  bfloat16 rounding may differ
    between XLA's fused chains and torch's per-op rounding, so the port's
    cycle count is held to the JAX package's bf16 count +- 2, and its p to
    the JAX package's bf16 p at 1e-3 (the bf16 sweeps move the
    disconnected corner cells, a null-space component, in both packages);
    the float32 solves agree to 1e-4 (float32 rounding in two orders)."""
    cycles = {}
    b, d_u, d_v, dx, dy = system(n)
    for sd in ("float32", "bfloat16"):
        cfg = JMG(tolerance=1e-4, max_cycles=60, smoother_dtype=sd, check_every=1,
                  backend="xla")
        kw = dict(dx=dx, dy=dy, rho=1.0)
        pj, ij = jmg.multigrid_solve(jnp.asarray(b, jnp.float32), jnp.asarray(d_u, jnp.float32),
                                    jnp.asarray(d_v, jnp.float32),
                                    jnp.zeros((n, n), jnp.float32), cfg, **kw)
        pt, it = tmg.multigrid_solve(T(b, torch.float32), T(d_u, torch.float32),
                                     T(d_v, torch.float32),
                                     torch.zeros((n, n), dtype=torch.float32),
                                     interop.config(cfg), **kw)
        assert float(it.rel_residual) < 1e-4
        cycles[sd] = (it.iterations, int(ij.iterations))
        assert rel_err(pt, pj) < (1e-4 if sd == "float32" else 1e-3)
    assert cycles["bfloat16"][0] <= cycles["float32"][0] + 2
    assert cycles["float32"][0] == cycles["float32"][1]
    assert abs(cycles["bfloat16"][0] - cycles["bfloat16"][1]) <= 2


def test_bf16_smooth_is_the_error_form():
    """One bf16 smoothing call equals the float32 error-form sweeps
    rounded to bfloat16 (p + e), to bfloat16's rounding of e."""
    jl, tl, _ = both_levels(32, JMG(), dtype=(jnp.float32, torch.float32))
    rng = np.random.default_rng(8)
    st, shp, five, _ = tl[0]
    p = T(rng.normal(size=shp), torch.float32)
    b = T(rng.normal(size=shp), torch.float32)
    cfg16 = tmg.MultigridConfig(smoother_dtype="bfloat16")
    cfg32 = tmg.MultigridConfig()
    got = tmg._smooth(p, b, st, cfg16, 2, five)
    r = b - tst9.apply_five(p, st, five)
    e32 = tmg._smooth(torch.zeros_like(p), r, st, cfg32, 2, five)
    assert got.dtype == torch.float32
    assert float((got - (p + e32)).abs().max()) <= 2 ** -6 * float(e32.abs().max())
    jgot = jmg._smooth(jnp.asarray(p.numpy()), jnp.asarray(b.numpy()), jl[0][0],
                       dataclasses.replace(JMG(), smoother_dtype="bfloat16"), 2, five)
    assert float(np.abs(got.numpy() - np.asarray(jgot)).max()) <= 2 ** -6 * float(
        e32.abs().max())
