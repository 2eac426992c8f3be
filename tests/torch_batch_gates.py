"""Shared by the large-grid batch tests (``test_torch_batch_large_step.py``
and ``test_torch_batch_large_jax.py``): the kernel gates forced open and
scaled down so that a 64^2 grid takes the path a 1024^2 one takes on the
card, and the plain calls of K1, K2a, K2b, K3 and K5 counted."""

import pytest
from naviflow_tpu.solvers import ChebyshevMomentumConfig
from naviflow_tpu.solvers.multigrid import MultigridConfig as JMG

from naviflow_tpu_torch.algorithms import batch as tbatch
from naviflow_tpu_torch.ops import _cuda, asmcheby, mg, strip
from naviflow_tpu_torch.solvers import momentum as tmom
from naviflow_tpu_torch.solvers import multigrid as tmg

RES = (100.0, 400.0, 1000.0)
N, STEPS = 64, 10
# bench.py's large-grid configuration
MOM = ChebyshevMomentumConfig(degree=4)
PRES = JMG(tolerance=0.0, max_cycles=1, cycle_type="v", pre_smoothing=1, post_smoothing=1,
           coarsest_sweeps=32, coarse_rebuild_every=8)


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

    def count(module, name, key):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

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
        count(module, name, key)
    return calls
