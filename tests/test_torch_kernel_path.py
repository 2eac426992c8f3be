"""The port's kernel-path structure, forced on the CPU.

With the CUDA gate forced open, a 64^2 float32 solve takes the path a
1024^2 CUDA solve takes: the lagged-Gershgorin carry with the merged
momentum kernel (K1), and the peeled V-cycle with strip levels (K2) and a
fused tail (K3); on CPU tensors every kernel wrapper runs its plain
version.  The JAX package runs the same steps with its merged Pallas
kernel forced, in interpret mode.  The gates for kernels the port does not
have yet refuse with NotImplementedError.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
import naviflow_tpu.ops.pallas_asmcheby as jpa
from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu.algorithms.simple import _build_solve
from naviflow_tpu.solvers import ChebyshevMomentumConfig
from naviflow_tpu.solvers.multigrid import MultigridConfig

import naviflow_tpu_torch as nt
import naviflow_tpu_torch.solvers.momentum as tmom
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import simple_solve as port_simple_solve
from naviflow_tpu_torch.ops import _cuda, asmcheby, mg, strip

torch.set_num_threads(2)
# no TF32 anywhere a float32 product could run (none does on these paths)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MOM = ChebyshevMomentumConfig(degree=4)
PRES = MultigridConfig(tolerance=0.0, max_cycles=1, cycle_type="v",
                       pre_smoothing=1, post_smoothing=1, coarsest_sweeps=32,
                       coarse_rebuild_every=8)


@pytest.fixture
def kernel_gates_open(monkeypatch):
    """Treat CPU tensors as kernel-capable; admit K1 at any size, and shrink
    the fused V-cycle's budget so 64^2 peels its finest level (strip) and
    fuses the 32^2 tail, as 1024^2 peels two levels and fuses from 256^2."""
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

    count(asmcheby, "fused_asmcheby_pair_plain")
    count(strip, "strip_down_plain")
    count(strip, "strip_up_plain")
    count(mg, "fused_vcycle_plain")
    return calls


def test_forced_kernel_path_matches_jax_merged_kernel(kernel_gates_open, monkeypatch):
    """4 steps at 64^2 in float32, rel 1e-4 against the JAX package with its
    merged momentum kernel forced (interpret mode)."""
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
    assert tmom.lagged_rho_enabled(n, n, interop.config(MOM), fold_poisson=True,
                                   dtype=torch.float32, device=state0.u.device)
    ts, td = port_simple_solve(tmesh, interop.fluid(fluid), tbc, state0,
                               interop.config(cfg), momentum=interop.config(MOM),
                               pressure=interop.config(PRES))
    # every step went through the four kernel wrappers (plain on the CPU)
    assert kernel_gates_open == {"fused_asmcheby_pair_plain": steps,
                                 "strip_down_plain": steps, "strip_up_plain": steps,
                                 "fused_vcycle_plain": steps}
    for name in ("u", "v", "p"):
        got, want = getattr(ts, name).numpy(), js[name]
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-4, name
    np.testing.assert_allclose(td.u_res_history.numpy(), j_hist, rtol=1e-4)


def test_unported_kernel_gates_refuse(kernel_gates_open):
    """Where the reference would launch a kernel the port lacks, the port
    raises; backend='composed' runs the composed path instead."""
    from naviflow_tpu_torch.solvers.momentum import JacobiMomentumConfig
    from naviflow_tpu_torch.solvers.multigrid import MultigridConfig as TMG
    from naviflow_tpu_torch.solvers.multigrid import multigrid_solve

    # K5, now ported: the whole 16^2 hierarchy fits the fused budget, so the
    # solve goes through its wrapper (the plain version on the CPU)
    n = 16
    d_u = torch.rand((n + 1, n)) + 0.5
    d_v = torch.rand((n, n + 1)) + 0.5
    b = torch.randn((n, n))
    kw = dict(dx=1.0 / n, dy=1.0 / n, rho=1.0)
    calls = []
    real = mg.fused_mg_solve_plain
    mg.fused_mg_solve_plain = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        p, info = multigrid_solve(b, d_u, d_v, torch.zeros_like(b), TMG(), **kw)
    finally:
        mg.fused_mg_solve_plain = real
    assert calls == [1] and torch.isfinite(p).all()
    p, info = multigrid_solve(b, d_u, d_v, torch.zeros_like(b), TMG(backend="composed", max_cycles=2), **kw)
    assert torch.isfinite(p).all()

    # K8: fused assembly at 384 x 256 with a non-merged momentum config
    mesh = nt.StructuredMesh(nx=384, ny=256)
    bc = nt.lid_driven_cavity(1.0)
    s = nt.initialize_state(mesh, bc, device="cpu")
    kw = dict(dx=mesh.dx, dy=mesh.dy, rho=1.0, mu=0.01, alpha=0.7, bc=bc)
    with pytest.raises(NotImplementedError, match="K8"):
        tmom.solve_momentum_pair(s.u, s.v, s.p, cfg=JacobiMomentumConfig(), **kw)

    # a lagged carry the helper does not admit is refused
    with pytest.raises(ValueError, match="lagged_rho_enabled"):
        tmom.solve_momentum_pair(s.u, s.v, s.p, cfg=tmom.ChebyshevMomentumConfig(
            backend="composed"), poisson_variant="consistent",
            lagged_rho=(torch.tensor(0.999), torch.tensor(0.999)), **kw)
