"""The one-pass momentum assembly (K8) and the Chebyshev solve + residual
kernel (K9) of the PyTorch port, on the CPU: their plain versions (what
each wrapper runs on a CPU tensor) against the JAX package's Pallas kernels
in interpret mode, at the JAX kernel tests' tolerances; and the large-grid
dispatch of SIMPLEC, PISO, SIMPLER and SIMPLE with BiCGSTAB momentum with
the kernel gates forced open (which kernel runs how often per step, as
``chip_smoke.py`` asserts on the card at 2048^2).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.core.bc import apply_velocity_bcs
from naviflow_tpu.ops.pallas_assembly import fused_assembly_pair as j_assembly
from naviflow_tpu.ops.pallas_cheby import chebyshev_momentum_strips as j_cheby
from naviflow_tpu.ops.powerlaw import relax_coefficients
from naviflow_tpu.solvers.momentum import (_assemble_coeffs, _chebyshev_bounds, _u_interior_mask,
                                           _v_interior_mask)

import naviflow_tpu_torch as nt
import naviflow_tpu_torch.solvers.momentum as tmom
from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops import _cuda, asmcheby, assembly, cheby, mg, strip
from naviflow_tpu_torch.solvers import (ChebyshevMomentumConfig, KrylovMomentumConfig,
                                        MultigridConfig)

torch.set_num_threads(2)
# no TF32 anywhere a float32 product could run (none does on these paths)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ALPHA = 0.7
FIELDS = ("a_e", "a_w", "a_n", "a_s", "a_p", "src")


def T(x):
    return interop.tensor(x, dtype=torch.float32)


def _cavity_fields(nx, ny, seed):
    """A BC-applied cavity state plus seeded noise (the JAX kernel tests')."""
    rng = np.random.default_rng(seed)
    mesh = nf.StructuredMesh(nx=nx, ny=ny)
    bc = nf.lid_driven_cavity(1.0)
    st = nf.initialize_state(mesh, bc, dtype=jnp.float32)
    u = jnp.asarray(st.u + 0.1 * rng.normal(size=st.u.shape), jnp.float32)
    v = jnp.asarray(st.v + 0.1 * rng.normal(size=st.v.shape), jnp.float32)
    p = jnp.asarray(rng.normal(size=st.p.shape), jnp.float32)
    u, v = apply_velocity_bcs(u, v, bc)
    return u, v, p, dict(dx=1.0 / (nx - 1), dy=1.0 / (ny - 1), rho=1.0, mu=0.01)


@pytest.mark.parametrize("variant", [None, "consistent", "symmetric", "reference"])
def test_k8_plain_matches_pallas_kernel(variant):
    """K8 at 64^2 with the Gershgorin maxima, without and with each Poisson
    fold: coefficients at rtol/atol 1e-5, maxima at rtol 1e-6, d and the
    pressure operator at rtol 1e-6 / atol 1e-9 (tests/test_pallas_assembly.py)."""
    u, v, p, kw = _cavity_fields(64, 64, seed=9 if variant is None else 11)
    want = j_assembly(u, v, p, alpha=ALPHA, interpret=True, with_bounds=True,
                      poisson_variant=variant, **kw)
    got = assembly.fused_assembly_pair(T(u), T(v), T(p), alpha=ALPHA, with_bounds=True,
                                       poisson_variant=variant, **kw)
    assert assembly.LAUNCHES == 0  # CPU tensors never launch
    assert len(got) == len(want) == (6 if variant is None else 9)
    for k in range(4):
        for name in FIELDS:
            np.testing.assert_allclose(getattr(got[k], name).numpy(),
                                       np.asarray(getattr(want[k], name)),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{k}.{name}")
    for k in (4, 5):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    if variant is not None:
        for k in (6, 7):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-9)
        for name in ("a_e", "a_w", "a_n", "a_s", "diag"):
            np.testing.assert_allclose(getattr(got[8], name).numpy(),
                                       np.asarray(getattr(want[8], name)), rtol=1e-6,
                                       atol=1e-9, err_msg=name)


@pytest.mark.parametrize("nx,ny,degree,is_u", [
    (64, 64, 4, True), (64, 64, 4, False), (64, 64, 6, True), (64, 64, 6, False),
    (96, 72, 5, True)])
def test_k9_plain_matches_pallas_kernel(nx, ny, degree, is_u):
    """K9: x* and the masked unrelaxed residual at 2e-5
    (tests/test_pallas_cheby.py), square at degrees 4 and 6 for both fields
    and on a 96 x 72 grid."""
    u, v, p, kw = _cavity_fields(nx, ny, seed=3 if nx == ny else 11)
    c_un = _assemble_coeffs(u, v, p, scheme="power_law", is_u=is_u, **kw)
    x0 = u if is_u else v
    c_rel = relax_coefficients(c_un, x0, ALPHA)
    mask = _u_interior_mask(u.shape) if is_u else _v_interior_mask(v.shape)
    theta, delta, sigma1 = _chebyshev_bounds(c_rel, mask)
    want_x, want_r = j_cheby(x0, c_rel, c_un, theta=theta, delta=delta, sigma1=sigma1,
                             degree=degree, interpret=True)
    got_x, got_r = cheby.chebyshev_momentum_strips(
        T(x0), interop.stencil_coeffs(c_rel, dtype=torch.float32),
        interop.stencil_coeffs(c_un, dtype=torch.float32),
        theta=T(theta), delta=T(delta), sigma1=T(sigma1), degree=degree)
    assert cheby.LAUNCHES == 0
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=2e-5, atol=2e-5)


# the bench's 2048^2 large-grid configuration (bench.py:_bench_large_grid),
# and its BENCH_MOM=bicgstab momentum
CHEBY = ChebyshevMomentumConfig(degree=4)
KRYLOV = KrylovMomentumConfig(tolerance=1e-6, max_iterations=5)
PRES = MultigridConfig(tolerance=0.0, max_cycles=1, cycle_type="v", pre_smoothing=1,
                       post_smoothing=1, coarsest_sweeps=32, coarse_rebuild_every=8)

# algo -> (config, momentum, per-step launches of K8, K9, pressure solves)
LARGE = {
    "simplec": (talg.SIMPLECConfig, CHEBY, 1, 2, 1),
    "piso": (talg.PISOConfig, CHEBY, 2, 2, 2),
    "simpler": (talg.SIMPLERConfig, CHEBY, 2, 4, 2),
    "simple": (talg.SIMPLEConfig, KRYLOV, 1, 0, 1),
}


@pytest.fixture
def large_grid_gates_open(monkeypatch):
    """Treat CPU tensors as kernel-capable, admit K8 and K9 at 64^2, keep K7
    out (its budget refuses 2048^2 fields), and shrink the fused V-cycle's
    budget so 64^2 peels its finest level (K2) and fuses the tail (K3), as
    2048^2 peels its fine levels.  Counts each kernel wrapper's plain calls."""
    monkeypatch.setattr(_cuda, "kernel_device", lambda x: True)
    monkeypatch.setattr(tmom, "supports_fused_assembly",
                        lambda nx, ny, scheme, dtype, backend, device: backend != "composed")
    monkeypatch.setattr(tmom, "supports_cheby_strips", lambda *a: True)
    monkeypatch.setattr(tmom, "supports_fused_bicgstab", lambda *a: False)
    monkeypatch.setattr(mg, "VMEM_BUDGET_BYTES", 400_000)
    calls = {}

    def count(module, name, key):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    count(asmcheby, "fused_asmcheby_pair_plain", "K1")
    count(strip, "strip_down_plain", "K2a")
    count(strip, "strip_up_plain", "K2b")
    count(mg, "fused_vcycle_plain", "K3")
    count(mg, "fused_mg_solve_plain", "K5")
    count(assembly, "fused_assembly_pair_plain", "K8")
    count(cheby, "chebyshev_momentum_strips_plain", "K9")
    return calls


@pytest.mark.parametrize("algo", list(LARGE))
def test_large_grid_dispatch(large_grid_gates_open, algo):
    """Three steps at 64^2 in float32 through the large-grid path: per step
    K8 once per momentum solve, K9 once per field and Chebyshev solve, one
    strip pair and one K3 tail per pressure solve, K1 never.  The fields
    agree with the composed run to 1e-4 of their scale."""
    calls = large_grid_gates_open
    cls, mom, k8, k9, psolves = LARGE[algo]
    steps, n = 3, 64
    mesh = nt.StructuredMesh(nx=n, ny=n)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=100)
    bc = nt.lid_driven_cavity(1.0)
    solve = getattr(talg, f"{algo}_solve")

    def run(m, pres):
        return solve(mesh, fluid, bc, nt.initialize_state(mesh, bc, device="cpu"),
                     cls(max_iterations=steps, tolerance=0.0), momentum=m, pressure=pres)

    ks, kd = run(mom, PRES)
    want = {"K8": k8 * steps, "K9": k9 * steps, "K2a": psolves * steps,
            "K2b": psolves * steps, "K3": psolves * steps}
    assert calls == {k: c for k, c in want.items() if c}
    calls.clear()
    cs, cd = run(dataclasses.replace(mom, backend="composed"),
                 dataclasses.replace(PRES, backend="composed"))
    # PISO's Jacobi corrector config has no backend switch, in the JAX
    # package as here: its momentum pair takes K8 on the composed run too
    assert calls == ({"K8": steps} if algo == "piso" else {})
    for name in ("u", "v", "p"):
        got, ref = getattr(ks, name), getattr(cs, name)
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), name
    hist = kd.total_res_history
    assert bool(torch.isfinite(hist).all())
