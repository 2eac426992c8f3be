"""The port's outer-loop modes and stall detector against the JAX package's
on the CPU (float64): ``'fused'``, ``'host'`` and ``'chunked:K'`` with and
without the lagged coarse rebuild at 32^2 (31^2:
``test_torch_loops_sequencing_odd.py``), ``on_chunk``'s boundaries and early
stop, and ``_StallDetector`` on the same sequences and on a plateauing
solve.  (Grid sequencing and Reynolds continuation:
``test_torch_sequencing.py``.)"""

import numpy as np
import pytest
import torch
from torch_loops import LOOPS, assert_same_solve, both_simple, check_loop_mode

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig
from naviflow_tpu.algorithms.base import _StallDetector as JStall
from naviflow_tpu.solvers import MultigridConfig

import naviflow_tpu_torch as nt
from naviflow_tpu_torch.algorithms import simple_solve as t_simple_solve
from naviflow_tpu_torch.algorithms.base import _StallDetector as TStall

torch.set_num_threads(2)


# two-level hierarchies (32 -> 16, 31 -> 15) keep the JAX compiles short; the
# 31^2 cases are test_torch_loops_sequencing_odd.py's
@pytest.mark.parametrize("n,loop,rebuild", [(32, loop, rebuild) for loop in LOOPS
                                            for rebuild in (1, 8)])
def test_loop_modes_match_jax(n, loop, rebuild):
    """Each loop mode at 32^2 against the JAX package's
    (``torch_loops.check_loop_mode``)."""
    check_loop_mode(n, loop, rebuild)


def test_on_chunk_boundaries_and_early_stop():
    """on_chunk sees the same (iteration, total) at every chunk boundary in
    both packages; returning False stops at the first boundary; a
    non-chunked loop refuses it."""
    cfg = SIMPLEConfig(max_iterations=300, tolerance=1.3e-3)
    pres = MultigridConfig(tolerance=1e-2, max_cycles=6, check_every=2, coarsest_sweeps=8,
                           coarsest_grid_size=16)

    def recorder(log):
        def hook(it, total, carry):
            log.append((it, total))
            assert carry["it"] == it
        hook.log = log
        return hook

    j, t, hooks = both_simple(32, cfg, pres, "chunked:37", on_chunk=recorder)
    assert_same_solve(j, t)
    jlog, tlog = hooks[0].log, hooks[1].log
    assert 37 < t[1].iterations < 74
    assert [it for it, _ in tlog] == [it for it, _ in jlog] == [37, t[1].iterations]
    np.testing.assert_allclose([x for _, x in tlog], [x for _, x in jlog], rtol=1e-10)

    def stopper(log):
        return lambda it, total, carry: False

    j, t, _ = both_simple(31, SIMPLEConfig(max_iterations=300, tolerance=1e-12), pres,
                          "chunked:10", on_chunk=stopper)
    assert t[1].iterations == int(j[1].iterations) == 10
    assert_same_solve(j, t)
    mesh = nt.StructuredMesh(nx=8, ny=8)
    bc = nt.lid_driven_cavity(1.0)
    for loop in ("fused", "host"):
        with pytest.raises(ValueError, match="on_chunk"):
            t_simple_solve(mesh, nt.FluidProperties(reynolds_number=10), bc,
                           nt.initialize_state(mesh, bc, device="cpu"), loop=loop,
                           on_chunk=lambda *a: None)
    with pytest.raises(ValueError, match="loop mode"):
        t_simple_solve(mesh, nt.FluidProperties(reynolds_number=10), bc,
                       nt.initialize_state(mesh, bc, device="cpu"), loop="bogus")


STALL_SEQUENCES = {
    "plateau": [1e-3 * (1 + 1e-5 * k) for k in range(12)],
    "falling": [1e-2 * 0.9 ** k for k in range(12)],
    "plateau_then_fall": [1.0] * 8 + [0.5, 0.25],
    "fall_then_plateau": [2.0, 1.5, 1.2] + [1.0 + 1e-4 * (-1) ** k for k in range(9)],
    "zeros": [0.0] * 8,
}


@pytest.mark.parametrize("name", list(STALL_SEQUENCES))
@pytest.mark.parametrize("sample_every", [1, 10, 37, 400])
def test_stall_detector_matches_jax(name, sample_every):
    """The verdict after every sample equals the JAX package's."""
    seq = STALL_SEQUENCES[name]
    jd, td = JStall(sample_every=sample_every), TStall(sample_every=sample_every)
    assert td.n_samples == jd.n_samples
    for x in seq:
        assert td.update(x) == jd.update(x)
    assert td.stalled == jd.stalled


@pytest.mark.parametrize("loop", ["host", "chunked:25"])
def test_plateauing_solve_is_stalled(loop):
    """The reference operator with the boundary-pressure overwrite floors
    the outer residual near 1e-3 (the JAX package's
    ``test_reference_parity_mode_stalls_like_reference``): both packages
    flag the solve stalled, with the same iterations and histories."""
    cfg = SIMPLEConfig(max_iterations=400, tolerance=1e-6, poisson_variant="reference",
                       overwrite_boundary_pressure=True)
    j, t, _ = both_simple(15, cfg, nf.solvers.RBGSPressureConfig(), loop)
    assert_same_solve(j, t, rtol=1e-9)
    assert bool(t[1].stalled) and not bool(t[1].converged)
