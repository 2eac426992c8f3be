"""The whole-step kernel K6's ``simplec``, ``piso`` and ``simpler`` bodies
in the PyTorch port, on the CPU: their plain versions against the JAX step
bodies they stand for, and the dispatch with the kernel gates forced open
(one K6 per outer step, as ``chip_smoke.py`` asserts on the card), with the
bench's 63^2 headline configuration at 31^2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import naviflow_tpu as nf

from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops import _cuda, krylov, mg, step

from test_torch_algorithms import ALGOS, MOM, PRES, _case, _port_solve, rel_err

torch.set_num_threads(2)
# no TF32 anywhere a float32 product could run (none does on these paths)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("algo", ["simplec", "piso", "simpler"])
def test_k6_plain_body_matches_jax_step_body(algo):
    """K6's plain body (ops/step.fused_outer_step on CPU tensors), three
    chained steps from rest at 31^2, against the JAX package's step body
    with the kernel's own semantics (compensated momentum dots and
    residual, coarse operators rebuilt for every solve): u, v, p within
    2e-4, equal multigrid cycle counts, the scalar carries within 2e-4
    (tests/test_pallas.py's K6 tolerances)."""
    module, cfg, _ = ALGOS[algo]
    make_step = getattr(module, f"make_{algo}_step")
    mesh, _, bc = _case()
    dx, dy = mesh.get_cell_sizes()
    mom_k6 = dataclasses.replace(MOM, compensated_dots=True, compensated_residual=True)
    pres_k6 = dataclasses.replace(PRES, coarse_rebuild_every=1)
    jstep = jax.jit(make_step(dx=dx, dy=dy, rho=1.0, mu=0.01, bc=bc, cfg=cfg, mom_cfg=mom_k6,
                              pres_cfg=pres_k6))
    tbc = interop.boundary_conditions(bc)
    s = nf.initialize_state(mesh, bc)
    u, v, p = s.u, s.v, s.p
    if algo == "simplec":
        extra = (jnp.asarray(cfg.alpha_p, jnp.float32), jnp.asarray(jnp.inf, jnp.float32))
    else:
        extra = jnp.asarray(0.0, jnp.float32)

    def T(x):
        return interop.tensor(x, dtype=torch.float32)

    for it in range(3):
        u1, v1, p1, extra1, info = jstep(u, v, p, extra)
        scalars = extra if algo == "simplec" else (extra,)
        u2, v2, p2, sc, cyc, ru, rv, rp = step.fused_outer_step(
            algo, T(u), T(v), T(p), tuple(T(x) for x in scalars), dx=dx, dy=dy, rho=1.0,
            mu=0.01, bc=tbc, cfg=interop.config(cfg), mom_cfg=interop.config(MOM),
            pres_cfg=interop.config(PRES))
        for name, a, b in (("u", u2, u1), ("v", v2, v1), ("p", p2, p1)):
            assert rel_err(a, b) < 2e-4, (it, name, rel_err(a, b))
        assert int(cyc) == int(info.inner_iterations), it
        want = ((extra1[0], extra1[1], info.u_norm, info.v_norm, info.p_norm)
                if algo == "simplec" else (extra1, info.u_norm, info.v_norm, info.p_norm))
        if algo == "simpler":  # the carry passes through, as in the JAX body
            want = (extra,) + want[1:]
        for k, (a, b) in enumerate(zip(sc, want)):
            assert abs(float(a) - float(b)) <= 2e-4 * abs(float(b)) + 1e-6, (it, k)
        u, v, p, extra = u1, v1, p1, extra1
    assert step.LAUNCHES == 0  # CPU tensors never launch


@pytest.fixture
def kernel_gates_open(monkeypatch):
    """Treat CPU tensors as kernel-capable and count each kernel wrapper's
    plain calls: the path a CUDA float32 state takes, on the CPU."""
    monkeypatch.setattr(_cuda, "kernel_device", lambda x: True)
    calls = {}

    def count(module, name, key):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    count(step, "fused_outer_step_plain", "K6")
    count(mg, "galerkin_levels_plain", "K4")
    count(mg, "fused_mg_solve_plain", "K5")
    count(krylov, "bicgstab_momentum_plain", "K7")
    count(mg, "fused_vcycle_plain", "K3")
    return calls


@pytest.mark.parametrize("name", ["simplec", "piso", "simpler"])
def test_headline_dispatch_is_one_k6_per_step(kernel_gates_open, name):
    """With the gates open each algorithm runs one K6 per outer step and K4
    once (the setup rebuild of the lagged carry); nothing else launches.
    To 1e-3 the iteration count stays within 2 (5% for SIMPLEC, whose
    alpha_p backoff is a yes/no decision) of the composed run's."""
    calls = kernel_gates_open
    cfg = dataclasses.replace(ALGOS[name][1], max_iterations=400, tolerance=1e-3)
    ts, td = _port_solve(name, cfg)
    assert td.converged
    assert calls == {"K6": td.iterations, "K4": 1}
    calls.clear()
    _, tc = _port_solve(name, cfg, mom=dataclasses.replace(MOM, backend="xla"),
                        pres=dataclasses.replace(PRES, backend="xla"))
    assert calls == {} and tc.converged
    slack = max(2, 0.05 * tc.iterations) if name == "simplec" else 2
    assert abs(td.iterations - tc.iterations) <= slack
