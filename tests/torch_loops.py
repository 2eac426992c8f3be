"""Shared by the loop-mode tests (``test_torch_loops_sequencing.py`` and
``test_torch_loops_sequencing_odd.py``): the same SIMPLE solve through both
packages on the CPU (float64) and the comparison of the two."""

import jax.numpy as jnp
import numpy as np
import torch

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu.solvers import MultigridConfig

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import simple_solve as t_simple_solve

HISTORIES = ("u_res_history", "v_res_history", "p_res_history", "total_res_history")


def rel_err(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))


def both_simple(n, cfg, pres, loop, *, re=100, on_chunk=None, **kw):
    """The same SIMPLE solve through both packages from rest (float64);
    ``on_chunk`` gets a list to record into, one per package."""
    mesh = nf.StructuredMesh(nx=n, ny=n)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=re)
    bc = nf.lid_driven_cavity(1.0)
    hooks = [None, None] if on_chunk is None else [on_chunk([]), on_chunk([])]
    js, jd = simple_solve(mesh, fluid, bc, nf.initialize_state(mesh, bc, dtype=jnp.float64),
                          cfg, pressure=pres, loop=loop, on_chunk=hooks[0], **kw)
    tmesh, tbc = interop.mesh(mesh), interop.boundary_conditions(bc)
    ts, td = t_simple_solve(tmesh, interop.fluid(fluid), tbc,
                            nt.initialize_state(tmesh, tbc, dtype=torch.float64, device="cpu"),
                            interop.config(cfg), pressure=interop.config(pres), loop=loop,
                            on_chunk=hooks[1],
                            **{k: interop.config(v) for k, v in kw.items()})
    return (js, jd), (ts, td), hooks


def assert_same_solve(j, t, rtol=1e-10):
    (js, jd), (ts, td) = j, t
    k = int(jd.iterations)
    assert td.iterations == k
    assert bool(td.converged) == bool(jd.converged)
    assert bool(td.stalled) == bool(jd.stalled)
    for name in HISTORIES:
        np.testing.assert_allclose(getattr(td, name).numpy()[:k], np.asarray(getattr(jd, name))[:k],
                                   rtol=rtol, atol=1e-300)
    np.testing.assert_array_equal(td.inner_iters_history.numpy()[:k],
                                  np.asarray(jd.inner_iters_history)[:k])
    for name in ("u", "v", "p"):
        assert rel_err(getattr(ts, name), getattr(js, name)) < rtol, name


LOOPS = ("fused", "host", "chunked:37", "chunked:10")


def check_loop_mode(n, loop, rebuild):
    """One loop mode at n^2, Re=100, to 1.7e-3 (~50 iterations, so
    chunked:37 crosses a boundary), with the lagged coarse rebuild every
    ``rebuild`` steps: iterations, histories and inner iterations equal to
    the same JAX loop mode, fields to 1e-10.  The host loop overshoots to a
    multiple of 10; chunked:10 with the rebuild every 8 refreshes at every
    chunk start as well."""
    cfg = SIMPLEConfig(max_iterations=300, tolerance=1.7e-3)
    pres = MultigridConfig(tolerance=1e-2, max_cycles=6, check_every=2, coarsest_sweeps=8,
                           coarsest_grid_size=16, coarse_rebuild_every=rebuild)
    j, t, _ = both_simple(n, cfg, pres, loop)
    assert_same_solve(j, t)
    k = t[1].iterations
    assert k > 37
    if loop == "host":
        assert k % 10 == 0
    assert bool(t[1].converged)
