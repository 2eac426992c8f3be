"""Each kernel module of the PyTorch port, on CPU tensors (where its wrapper
runs the plain PyTorch version), against the JAX package's Pallas kernel
run in interpret mode.  float32, with the JAX kernel tests' own
tolerances.  The CUDA kernels themselves are held to these plain versions
on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.core.bc import apply_velocity_bcs
from naviflow_tpu.ops.pallas_asmcheby import fused_asmcheby_pair as j_asmcheby
from naviflow_tpu.ops.pallas_mg import fused_vcycle as j_vcycle
from naviflow_tpu.ops.pallas_strip import strip_down as j_down
from naviflow_tpu.ops.pallas_strip import strip_up as j_up
from naviflow_tpu.ops.powerlaw import (relax_coefficients, u_momentum_coefficients,
                                       v_momentum_coefficients)
from naviflow_tpu.solvers.momentum import _bounds_from_rho, _u_interior_mask, _v_interior_mask
from naviflow_tpu.solvers.multigrid import MultigridConfig as JMultigridConfig

from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops import asmcheby, mg, strip

torch.set_num_threads(2)
# no TF32 anywhere a float32 product could run (none does on these paths)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ALPHA = 0.7


def rel_err(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-30)


def T(x):
    return interop.tensor(x, dtype=torch.float32)


def _cavity_fields(n, seed=7):
    rng = np.random.default_rng(seed)
    mesh = nf.StructuredMesh(nx=n, ny=n)
    bc = nf.lid_driven_cavity(1.0)
    st = nf.initialize_state(mesh, bc, dtype=jnp.float32)
    u = jnp.asarray(st.u + 0.1 * rng.normal(size=st.u.shape), jnp.float32)
    v = jnp.asarray(st.v + 0.1 * rng.normal(size=st.v.shape), jnp.float32)
    p = jnp.asarray(rng.normal(size=st.p.shape), jnp.float32)
    u, v = apply_velocity_bcs(u, v, bc)
    return u, v, p, dict(dx=1.0 / (n - 1), dy=1.0 / (n - 1), rho=1.0, mu=0.01)


@pytest.mark.parametrize("degree,variant", [(4, "consistent"), (6, "symmetric")])
def test_asmcheby_plain_matches_pallas_kernel(degree, variant):
    """K1 at 64^2: tolerances of tests/test_pallas_asmcheby.py (2e-5 on
    fields and operators, 5e-5 on residuals, 1e-6 on the maxima)."""
    u, v, p, kw = _cavity_fields(64)

    def raw_rho(c_un, c_rel, mask):  # the bootstrap interval, as the JAX test
        safe = jnp.where(c_rel.a_p == 0, 1.0, c_rel.a_p)
        nb = jnp.abs(c_un.a_e) + jnp.abs(c_un.a_w) + jnp.abs(c_un.a_n) + jnp.abs(c_un.a_s)
        return jnp.max(jnp.where(mask, nb / safe, 0.0))

    cu = u_momentum_coefficients(u, v, p, **kw)
    cv = v_momentum_coefficients(u, v, p, **kw)
    rho_u = raw_rho(cu, relax_coefficients(cu, u, ALPHA), _u_interior_mask(u.shape))
    rho_v = raw_rho(cv, relax_coefficients(cv, v, ALPHA), _v_interior_mask(v.shape))
    bu, bv = _bounds_from_rho(rho_u, 1.05), _bounds_from_rho(rho_v, 1.05)

    want = j_asmcheby(u, v, p, alpha=ALPHA, degree=degree, bounds_u=bu, bounds_v=bv,
                      poisson_variant=variant, interpret=True, **kw)
    got = asmcheby.fused_asmcheby_pair(
        T(u), T(v), T(p), alpha=ALPHA, degree=degree,
        bounds_u=tuple(T(s) for s in bu), bounds_v=tuple(T(s) for s in bv),
        poisson_variant=variant, **kw)
    assert asmcheby.LAUNCHES == 0  # CPU tensors never launch
    tol = [2e-5, 5e-5, 2e-5, 5e-5, 2e-5, 2e-5]  # u*, r_u, v*, r_v, d_u, d_v
    for k, t in enumerate(tol):
        assert rel_err(got[k], want[k]) < t, k
    for name in ("a_e", "a_w", "a_n", "a_s", "diag"):
        assert rel_err(getattr(got[6], name), getattr(want[6], name)) < 2e-5, name
    assert rel_err(got[7], want[7]) < 1e-6
    assert rel_err(got[8], want[8]) < 1e-6


def _fine_stencil(n, rng):
    """A 5-point consistent pressure operator from random d-fields (port
    ops, float32); both packages get the same arrays."""
    from naviflow_tpu_torch.ops.poisson import poisson_coefficients as t_poisson
    from naviflow_tpu_torch.ops.stencil9 import from_poisson as t_from_poisson

    d_u = torch.as_tensor(rng.uniform(0.5, 1.5, (n + 1, n)), dtype=torch.float32)
    d_v = torch.as_tensor(rng.uniform(0.5, 1.5, (n, n + 1)), dtype=torch.float32)
    return t_from_poisson(t_poisson(d_u, d_v, dx=1.0 / n, dy=1.0 / n, rho=1.0,
                                    variant="consistent"))


def _to_jax(st):
    from naviflow_tpu.ops.stencil9 import Stencil9

    return Stencil9(**{k: jnp.asarray(getattr(st, k).numpy()) for k in
                       ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")})


def _strip_problem(nine: bool, n=64):
    from naviflow_tpu_torch.ops.stencil9 import galerkin_coarsen as t_galerkin
    from naviflow_tpu_torch.ops.transfer_cc import prolong_cc as t_prolong
    from naviflow_tpu_torch.ops.transfer_cc import restrict_cc as t_restrict

    rng = np.random.default_rng(13 if nine else 4)
    st = _fine_stencil(2 * n if nine else n, rng)
    if nine:
        st = t_galerkin(st, t_restrict, t_prolong, n, n)
    p = jnp.asarray(rng.normal(size=(n, n)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(n, n)), jnp.float32)
    ec = jnp.asarray(rng.normal(size=(n // 2, n // 2)), jnp.float32)
    return st, p, b, ec


@pytest.mark.parametrize("nine,sweeps", [(False, 1), (True, 1), (True, 2)])
def test_strip_down_up_plain_match_pallas_kernels(nine, sweeps):
    """K2 at 64^2, 5- and 9-point, rtol 1e-5 / atol 1e-4 as
    tests/test_pallas_strip.py."""
    from naviflow_tpu_torch.solvers.multigrid import MultigridConfig

    tst, p, b, ec = _strip_problem(nine)
    jst = _to_jax(tst)
    jcfg = JMultigridConfig(pre_smoothing=sweeps, post_smoothing=sweeps)
    tcfg = MultigridConfig(pre_smoothing=sweeps, post_smoothing=sweeps)
    want_x, want_rc = j_down(p, b, jst, jcfg, five=not nine, interpret=True)
    got_x, got_rc = strip.strip_down(T(p), T(b), tst, tcfg, five=not nine)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_rc.numpy(), np.asarray(want_rc), rtol=1e-5, atol=1e-4)
    want_up = j_up(want_x, b, jst, ec, jcfg, five=not nine, interpret=True)
    got_up = strip.strip_up(T(want_x), T(b), tst, T(ec), tcfg, five=not nine)
    np.testing.assert_allclose(got_up.numpy(), np.asarray(want_up), rtol=1e-5, atol=1e-4)
    assert strip.STRIP_DOWN_LAUNCHES == strip.STRIP_UP_LAUNCHES == 0


def test_fused_vcycle_plain_matches_pallas_kernel():
    """K3 on a cell-centred 32^2 hierarchy over two chained cycles, rel
    1e-5 as tests/test_pallas.py."""
    from naviflow_tpu_torch.solvers.multigrid import MultigridConfig, build_levels

    n = 32
    rng = np.random.default_rng(5)
    d_u = torch.as_tensor(rng.random((n + 1, n)) + 0.5, dtype=torch.float32)
    d_v = torch.as_tensor(rng.random((n, n + 1)) + 0.5, dtype=torch.float32)
    b = rng.normal(size=(n, n)).astype(np.float32)
    b = b - b.mean()
    jcfg = JMultigridConfig(coarsest_sweeps=16)
    tcfg = MultigridConfig(coarsest_sweeps=16)
    tlev = build_levels(d_u, d_v, tcfg, dx=1.0 / n, dy=1.0 / n, rho=1.0,
                        variant="consistent")
    jlev = [(_to_jax(st), shape, five, None) for st, shape, five, _ in tlev]
    assert mg.supports_fused(tlev, tcfg) and len(tlev) == 4
    jp = jnp.zeros((n, n), jnp.float32)
    tp = torch.zeros((n, n), dtype=torch.float32)
    for _ in range(2):
        jp = j_vcycle(jp, jnp.asarray(b), jlev, jcfg, interpret=True)
        tp = mg.fused_vcycle(tp, T(b), tlev, tcfg)
        assert rel_err(tp, jp) < 1e-5
    assert mg.LAUNCHES == 0
