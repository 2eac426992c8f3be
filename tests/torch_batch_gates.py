"""Shared by the large-grid batch tests (``test_torch_batch_large_step.py``,
``test_torch_batch_large_jax.py``, ``test_torch_batch_assembly_step.py`` and
``test_torch_batch_loops_step.py``): the kernel gates forced open and
scaled down so that a 64^2 grid takes the path a 1024^2 one takes on the
card (``gates_open``: the plain calls of K1, K2a, K2b, K3 and K5 counted),
with K8's, K9's and K10's gates too the path of 2048^2 SIMPLEC / PISO /
SIMPLER and of the 4096^2 plane layout (``assembly_gates_open``: their
plain calls counted as well), and with K7's gate widened to float64 the
BiCGSTAB paths (``loops_gates_open``: K7's plain calls counted; a 32^2
field stands for the 256^2 ones K7 takes in its grid form, and
:func:`close_k7` shuts K7's gate as the 1024^2 fields find it)."""

import dataclasses

import numpy as np
import pytest
import torch
from naviflow_tpu.solvers import ChebyshevMomentumConfig
from naviflow_tpu.solvers.multigrid import MultigridConfig as JMG

from naviflow_tpu_torch import cli
from naviflow_tpu_torch.algorithms import batch as tbatch
from naviflow_tpu_torch.ops import (_cuda, asmcheby, assembly, cheby, krylov, mg, plane_strip,
                                    strip)
from naviflow_tpu_torch.solvers import momentum as tmom
from naviflow_tpu_torch.solvers import multigrid as tmg

RES = (100.0, 400.0, 1000.0)
N, STEPS = 64, 10
# bench.py's large-grid configuration
MOM = ChebyshevMomentumConfig(degree=4)
PRES = JMG(tolerance=0.0, max_cycles=1, cycle_type="v", pre_smoothing=1, post_smoothing=1,
           coarsest_sweeps=32, coarse_rebuild_every=8)
# the same in the colour-plane fine layout (bench.py's large_grid_3)
PLANE = dataclasses.replace(PRES, fine_layout="plane")
# the multigrid budget under which a 63^2 hierarchy takes the 511^2 path:
# K4's gate (14 padded fine arrays) opens at 31^2 and not at 63^2, K3 takes
# the 31^2 -> 7^2 tail and not the whole hierarchy, and so K5 refuses it
SCALED_BUDGET = 400_000
# the same path at 31^2: K4 from 15^2, K3 on the 15^2 -> 7^2 tail, the
# 31^2 level composed
SCALED_BUDGET_31 = 200_000


def _strip_gate(nx, ny, five, cfg, dtype):
    """The strip gate scaled down: every even square level of 32^2 and up
    (1024^2 and 512^2 on the card), any dtype."""
    return (nx == ny and nx % 2 == 0 and nx >= 32 and cfg.smoother == "gs"
            and max(cfg.pre_smoothing, cfg.post_smoothing) <= 2)


@pytest.fixture
def gates_open(monkeypatch):
    """CPU tensors treated as kernel-capable; K1's size gate down to 64^2;
    the strip gate down to 32^2 and K3's budget to the 16^2 tail (a 64^2
    hierarchy peels two levels as 1024^2 does); K3's and K5's dtype
    widened to float64 (the JAX package's precision).  Counts the plain
    calls of K1, K2a, K2b, K3 and K5, single and batched."""
    monkeypatch.setattr(_cuda, "kernel_device", lambda x: True)
    monkeypatch.setattr(tmom, "supports_asmcheby", lambda *a: True)
    monkeypatch.setattr(mg, "VMEM_BUDGET_BYTES", 300_000)
    monkeypatch.setattr(tmg, "supports_strip", _strip_gate)
    monkeypatch.setattr(tbatch, "supports_strip", _strip_gate)
    monkeypatch.setattr(tmg, "supports_fused", lambda levels, cfg: mg.supports_fused_layout(
        [(shp, five) for _, shp, five, _ in levels], cfg))
    calls = {}
    for module, name, key in (
            (asmcheby, "fused_asmcheby_pair_batched_plain", "K1 batched"),
            (asmcheby, "fused_asmcheby_pair_plain", "K1"),
            (strip, "strip_down_batched_plain", "K2a batched"),
            (strip, "strip_down_plain", "K2a"),
            (strip, "strip_up_batched_plain", "K2b batched"),
            (strip, "strip_up_plain", "K2b"),
            (mg, "fused_vcycle_batched_plain", "K3 batched"),
            (mg, "fused_vcycle_plain", "K3"),
            (mg, "fused_mg_solve_plain", "K5"),
            (tbatch, "_per_case", "per case")):
        _count(monkeypatch, calls, module, name, key)
    return calls


def _count(monkeypatch, calls, module, name, key):
    """Count the calls of ``module.name`` under ``calls[key]``."""
    real = getattr(module, name)

    def wrapped(*a, **k):
        calls[key] = calls.get(key, 0) + 1
        return real(*a, **k)

    monkeypatch.setattr(module, name, wrapped)


def _assembly_gate(nx, ny, scheme, dtype, backend, device):
    """K8's gate scaled down: power-law grids of 32^2 and up (384 x 256 on
    the card), any dtype, the kernel backend."""
    return backend in ("auto", "kernel") and scheme == "power_law" and min(nx, ny) >= 32


def _plane_gate(m, nc, cfg, dtype):
    """K10's gate with its dtype widened (the JAX package's float64)."""
    return plane_strip.supports_plane_strip(m, nc, cfg, torch.float32)


@pytest.fixture
def assembly_gates_open(gates_open, monkeypatch):
    """``gates_open``, K1's size gate back at 1024^2 (so SIMPLE takes K8
    where its lagged carry is off: below it), K8's and K9's gates down to
    32^2 and K10's widened to float64; counts the plain calls of K8, K9,
    K10a and K10b, single and batched, beside ``gates_open``'s."""
    calls = gates_open
    monkeypatch.setattr(tmom, "supports_asmcheby", asmcheby.supports_asmcheby)
    monkeypatch.setattr(tmom, "supports_fused_assembly", _assembly_gate)
    monkeypatch.setattr(tbatch, "supports_fused_assembly", _assembly_gate)
    monkeypatch.setattr(tmom, "supports_cheby_strips", lambda shape, dtype, device:
                        min(shape) >= 32)
    monkeypatch.setattr(tmg, "supports_plane_strip", _plane_gate)
    monkeypatch.setattr(tbatch, "supports_plane_strip", _plane_gate)
    for module, name, key in (
            (assembly, "fused_assembly_pair_batched_plain", "K8 batched"),
            (assembly, "fused_assembly_pair_plain", "K8"),
            (cheby, "chebyshev_momentum_strips_batched_plain", "K9 batched"),
            (cheby, "chebyshev_momentum_strips_plain", "K9"),
            (plane_strip, "plane_strip_down_batched_plain", "K10a batched"),
            (plane_strip, "plane_strip_down_plain", "K10a"),
            (plane_strip, "plane_strip_up_batched_plain", "K10b batched"),
            (plane_strip, "plane_strip_up_plain", "K10b")):
        _count(monkeypatch, calls, module, name, key)
    return calls


def batched_calls(per_step, steps, cases=len(RES)):
    """The plain calls of a batch of ``cases`` over ``steps`` lockstep
    steps: each kernel's batched calls (``per_step`` a step) and its single
    plain calls inside them, one a case."""
    want = {}
    for k, c in per_step.items():
        want[f"{k} batched"] = c * steps
        want[k] = c * steps * cases
    return want


def against_jax(calls, algorithm, momentum, pressure, per_step):
    """The port's batch of ``algorithm`` at N^2 over RES, STEPS fixed
    lockstep steps in float64 (the gates of ``assembly_gates_open``: the
    batched plain kernels under ``torch.func.vmap``), against the JAX
    package's ``batched_cavity_solve`` (one ``jax.vmap`` program of its
    composed step) to rel 1e-9 (``tests/test_torch_batch.py``'s limit) in
    u, v, p and every history step, with the exact batched calls."""
    import jax.numpy as jnp
    import naviflow_tpu as nf
    import naviflow_tpu.algorithms.batch as jbatch
    from naviflow_tpu import algorithms as jalg

    from naviflow_tpu_torch import algorithms as talg
    from naviflow_tpu_torch import interop

    def rel_err(got, want):
        got, want = got.numpy(), np.asarray(want)
        return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-30)

    mesh, bc = nf.StructuredMesh(nx=N, ny=N), nf.lid_driven_cavity(1.0)
    jcfg = getattr(jalg, f"{algorithm.upper()}Config")(max_iterations=STEPS, tolerance=0.0)
    jout = jbatch.batched_cavity_solve(mesh, list(RES), bc, jcfg, momentum, pressure,
                                       algorithm=algorithm, dtype=jnp.float64)
    calls.clear()
    tout = talg.batched_cavity_solve(interop.mesh(mesh), list(RES),
                                     interop.boundary_conditions(bc), interop.config(jcfg),
                                     interop.config(momentum), interop.config(pressure),
                                     algorithm=algorithm, dtype=torch.float64, device="cpu")
    assert calls == batched_calls(per_step, STEPS)
    for (js, jd), (ts, td) in zip(jout, tout):
        assert int(jd.iterations) == td.iterations == STEPS
        for name in ("u", "v", "p"):
            assert rel_err(getattr(ts, name), getattr(js, name)) <= 1e-9, name
        np.testing.assert_allclose(td.total_res_history.numpy(),
                                   np.asarray(jd.total_res_history), rtol=1e-9)
    assert not torch.equal(tout[0][0].u, tout[2][0].u)


@pytest.fixture
def loops_gates_open(assembly_gates_open, monkeypatch):
    """``assembly_gates_open`` with K7's gate widened to float64 (the JAX
    package's precision; its byte budget kept); counts K7's plain calls,
    single and batched, and K5's batched ones beside the others."""
    calls = assembly_gates_open

    def k7_gate(shape, dtype):
        return krylov.supports_fused_bicgstab(shape, torch.float32)

    monkeypatch.setattr(tmom, "supports_fused_bicgstab", k7_gate)
    monkeypatch.setattr(tbatch, "supports_fused_bicgstab", k7_gate)
    for module, name, key in ((krylov, "bicgstab_momentum_batched_plain", "K7 batched"),
                              (krylov, "bicgstab_momentum_plain", "K7"),
                              (mg, "fused_mg_solve_batched_plain", "K5 batched")):
        _count(monkeypatch, calls, module, name, key)
    return calls


def close_k7(monkeypatch):
    """K7's gate shut for every field (the 1024^2 fields are past its
    1 MiB): BiCGSTAB momentum takes the pair loop."""
    monkeypatch.setattr(krylov, "MAX_FIELD_BYTES", 0)


def open_k5(monkeypatch):
    """K5's budget back at the card's, so that it takes a whole 32^2
    hierarchy as it takes the 256^2 one on the card."""
    monkeypatch.setattr(mg, "VMEM_BUDGET_BYTES", 8 * 2**20)


@pytest.fixture
def odd_gates_open(loops_gates_open, monkeypatch):
    """``loops_gates_open`` with K8's own gate back (it refuses every grid
    below 384 x 256, and 511^2, which no strip width divides) and K4's plain
    calls counted, single and batched."""
    calls = loops_gates_open
    monkeypatch.setattr(tmom, "supports_fused_assembly", assembly.supports_fused_assembly)
    monkeypatch.setattr(tbatch, "supports_fused_assembly", assembly.supports_fused_assembly)
    for key, fn in (("K4 batched", "galerkin_levels_batched_plain"),
                    ("K4", "galerkin_levels_plain")):
        _count(monkeypatch, calls, mg, fn, key)
    return calls


def cli_solvers(*flags):
    """The momentum and pressure configurations of ``sweep --vmap
    <flags>``: the command line's parser and ``cli._make_solvers``."""
    return cli._make_solvers(cli._build_parser().parse_args(["sweep", "--vmap", *flags]))
