"""The vmapped large-grid batch of ``algorithms/batch.py`` (its even arm)
against the JAX package's ``batched_cavity_solve`` on the CPU (float64).

(d) With the kernel gates forced open and scaled down
(``torch_batch_gates``: a 64^2 grid takes the 1024^2 path), the batch to
rel 1e-9 of the JAX package's one ``jax.vmap`` program, with one batched
K1, two batched K2a, two batched K2b and one batched K3 call a lockstep
step and every single plain call inside them.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch
from torch_batch_gates import MOM, N, PRES, RES, STEPS, gates_open  # noqa: F401

import naviflow_tpu as nf
import naviflow_tpu.algorithms.batch as jbatch
import naviflow_tpu.ops.pallas_asmcheby as jpa
from naviflow_tpu.algorithms import SIMPLEConfig
from naviflow_tpu.algorithms.simple import make_simple_step as j_make_simple_step
from naviflow_tpu.ops.poisson import poisson_coefficients as j_poisson
from naviflow_tpu.ops.powerlaw import (d_coefficient, relax_coefficients,
                                       u_momentum_coefficients, v_momentum_coefficients)
from naviflow_tpu.ops.stencil import apply_stencil
from naviflow_tpu.solvers.momentum import (_chebyshev_iterate, _u_interior_mask,
                                           _v_interior_mask)

from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import batch as tbatch
from naviflow_tpu_torch.ops import asmcheby, mg, strip

torch.set_num_threads(2)


def _j_k1_plain(u, v, p, *, dx, dy, rho, mu, alpha, degree, bounds_u, bounds_v,
                poisson_variant="consistent", interpret=False):
    """K1's plain composition in the JAX package's operators (the port's
    ``fused_asmcheby_pair_plain``): assembly -> relax -> Chebyshev with the
    given bounds -> masked unrelaxed residual -> d -> pressure operator ->
    masked Gershgorin maxima; the viscosity a traced value under
    ``jax.vmap``."""
    del interpret
    kw = dict(dx=dx, dy=dy, rho=rho, mu=mu)
    cu = u_momentum_coefficients(u, v, p, **kw)
    cv = v_momentum_coefficients(u, v, p, **kw)
    cu_rel, cv_rel = relax_coefficients(cu, u, alpha), relax_coefficients(cv, v, alpha)
    mask_u, mask_v = _u_interior_mask(u.shape), _v_interior_mask(v.shape)
    x_u = _chebyshev_iterate(u, cu_rel, mask_u, *bounds_u, degree)
    x_v = _chebyshev_iterate(v, cv_rel, mask_v, *bounds_v, degree)
    r_u = jnp.where(mask_u, cu.src - apply_stencil(x_u, cu), 0.0)
    r_v = jnp.where(mask_v, cv.src - apply_stencil(x_v, cv), 0.0)
    d_u = d_coefficient(cu_rel.a_p, dy, is_u=True)
    d_v = d_coefficient(cv_rel.a_p, dx, is_u=False)
    pc = j_poisson(d_u, d_v, dx=dx, dy=dy, rho=rho, variant=poisson_variant)

    def ratio_max(c, mask):
        safe = jnp.where(c.a_p == 0, jnp.ones_like(c.a_p), c.a_p)
        nb = jnp.abs(c.a_e) + jnp.abs(c.a_w) + jnp.abs(c.a_n) + jnp.abs(c.a_s)
        return jnp.max(jnp.where(mask, nb / safe, jnp.zeros_like(nb)))

    return (x_u, r_u, x_v, r_v, d_u, d_v, pc, ratio_max(cu_rel, mask_u),
            ratio_max(cv_rel, mask_v))


def _j_batch(monkeypatch, mesh, bc, cfg):
    """The JAX package's ``batched_cavity_solve`` over ``RES`` in float64,
    its step given the lagged Gershgorin carry of K1's path: its batch
    builds each case's step without that carry (``batch.py``'s ``one``), so
    its composed step is the carry-free one, while its single
    ``_build_solve`` takes the carry where K1's gate is open; here the gate
    is open and K1 runs through its plain composition (the Pallas K1 closes
    over ``mu``, which a per-case viscosity cannot be under ``jax.vmap``)."""
    monkeypatch.setattr(jpa, "supports_asmcheby", lambda *a: True)
    monkeypatch.setattr(jpa, "fused_asmcheby_pair", _j_k1_plain)
    monkeypatch.setitem(jbatch._STEP_MAKERS, "simple",
                        functools.partial(j_make_simple_step, lagged_rho=True))
    real_extra0 = jbatch._extra0

    def extra0(*a, **k):
        dt = a[3]
        return (real_extra0(*a, **k), (jnp.asarray(0.999, dt), jnp.asarray(0.999, dt)))

    monkeypatch.setattr(jbatch, "_extra0", extra0)
    return jbatch.batched_cavity_solve(mesh, list(RES), bc, cfg, MOM, PRES, algorithm="simple",
                                       dtype=jnp.float64)


def rel_err(got, want):
    got, want = got.numpy(), np.asarray(want)
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-30)


def test_even_batch_matches_jax_vmap_program(gates_open, monkeypatch):
    """The large-grid configuration at 64^2, Re 100 / 400 / 1000, 10 fixed
    lockstep steps, float64: the port's even arm (the batched plain K1, K2
    and K3 under ``torch.func.vmap``) against the JAX package's
    ``batched_cavity_solve`` (one ``jax.vmap`` program, ``_j_batch``) to rel
    1e-9 (``tests/test_torch_batch.py``'s limit) in u, v, p and every
    history step; one batched K1, two batched K2a, two batched K2b and one
    batched K3 call a lockstep step, every single plain call one of their
    cases, no K5, no per-case step and no kernel launch."""
    calls = gates_open
    mesh, bc = nf.StructuredMesh(nx=N, ny=N), nf.lid_driven_cavity(1.0)
    cfg = SIMPLEConfig(max_iterations=STEPS, tolerance=0.0)
    jout = _j_batch(monkeypatch, mesh, bc, cfg)
    tcfg, tmom_cfg, tpres = interop.config(cfg), interop.config(MOM), interop.config(PRES)
    assert tbatch.vmap_step_ok(torch.zeros(N, N, dtype=torch.float64), tcfg, tmom_cfg, tpres,
                               "simple")
    calls.clear()
    tout = talg.batched_cavity_solve(interop.mesh(mesh), list(RES),
                                     interop.boundary_conditions(bc), tcfg, tmom_cfg, tpres,
                                     dtype=torch.float64, device="cpu")
    assert calls == {"K1 batched": STEPS, "K1": 3 * STEPS, "K2a batched": 2 * STEPS,
                     "K2a": 6 * STEPS, "K2b batched": 2 * STEPS, "K2b": 6 * STEPS,
                     "K3 batched": STEPS, "K3": 3 * STEPS}
    launches = (asmcheby.LAUNCHES, asmcheby.BATCH_LAUNCHES, strip.STRIP_DOWN_LAUNCHES,
                strip.STRIP_DOWN_BATCH_LAUNCHES, strip.STRIP_UP_LAUNCHES,
                strip.STRIP_UP_BATCH_LAUNCHES, mg.LAUNCHES, mg.VC_BATCH_LAUNCHES)
    assert launches == (0,) * 8
    for (js, jd), (ts, td) in zip(jout, tout):
        assert int(jd.iterations) == td.iterations == STEPS
        for name in ("u", "v", "p"):
            assert rel_err(getattr(ts, name), getattr(js, name)) <= 1e-9, name
        np.testing.assert_allclose(td.total_res_history.numpy(),
                                   np.asarray(jd.total_res_history), rtol=1e-9)
    # the cases differ (each its own viscosity)
    assert not torch.equal(tout[0][0].u, tout[2][0].u)
