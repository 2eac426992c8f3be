"""The vmapped lockstep step of ``algorithms/batch.py`` under the command
line's remaining ``sweep --vmap`` configurations, on the CPU in float32:
red-black GS and Jacobi momentum where K8's gate is shut, MGCG on odd grids
whose hierarchy K3 cannot take whole, and the dense direct pressure solve.

The kernel gates are forced open with K8's own gate back
(``torch_batch_gates.odd_gates_open``), so that a small grid takes the path
a large one takes on the card, with the command line's solvers
(``cli._make_solvers`` through ``torch_batch_gates.cli_solvers``):

* ``--momentum rbgs`` at 31^2, the odd arm as at the default 63^2: the
  momentum sweeps composed with each case's conductance row, a K4 and a K5
  a step;
* ``--momentum jacobi`` and ``--momentum rbgs`` at 32^2, the even arm as at
  256^2 (K8 refuses it, as it refuses every grid below 384^2): a K5 a step;
* ``--pressure mgcg`` at 31^2 with ``SCALED_BUDGET_31``, the path of
  ``--nx 511``: K7 a field, the 31^2 -> 15^2 level coarsened composed and
  a K4 from 15^2 a step, each application of the preconditioner a composed
  fine level and one K3 on the 15^2 -> 7^2 tail (the slowest case's CG
  count + 1 a step);
* ``--pressure direct`` at 15^2 and 16^2 (both arms): K7 a field; the
  dense matrix built out of place and factored case by case.

Each takes the vmapped branch with no ``_per_case`` step and no operator's
per-case fallback, one batched call of each kernel's plain version a
launch, each case's own single calls inside them, and each case bit-equal
to its single solve in u, v, p, every history step and every step's inner
iterations.  Then a lockstep step with a frozen case and both sides of the
widened gate.  (The batch against the JAX package's:
``test_torch_batch_cli_jax.py``.)
"""

import dataclasses
import warnings

import pytest
import torch
from torch_batch_gates import (RES, SCALED_BUDGET, SCALED_BUDGET_31,  # noqa: F401
                               assembly_gates_open, cli_solvers, gates_open, loops_gates_open,
                               odd_gates_open, open_k5)

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch.algorithms import batch as tbatch
from naviflow_tpu_torch.algorithms import simple as tsimple
from naviflow_tpu_torch.ops import mg, powerlaw
from naviflow_tpu_torch.solvers import ChebyshevMomentumConfig, GMRESMomentumConfig

torch.set_num_threads(2)

STEPS = 3
# name -> (grid, the command line's flags, each kernel's batched calls a
# lockstep step; MGCG's K3 is counted from the cases' CG counts)
CASES = {
    "rbgs31": (31, ("--momentum", "rbgs"), {"K4": 1, "K5": 1}),
    "jacobi32": (32, ("--momentum", "jacobi"), {"K5": 1}),
    "rbgs32": (32, ("--momentum", "rbgs"), {"K5": 1}),
    "mgcg31": (31, ("--pressure", "mgcg"), {"K4": 1, "K7": 2}),
    "direct15": (15, ("--pressure", "direct"), {"K7": 2}),
    "direct16": (16, ("--pressure", "direct"), {"K7": 2}),
}


def _budget(monkeypatch, n, mgcg):
    """The multigrid budget of the card's path: K5 at the card's budget on
    the even arm (256^2), ``SCALED_BUDGET_31`` for MGCG at 31^2 (511^2)."""
    if n % 2 == 0:
        open_k5(monkeypatch)
    elif mgcg:
        monkeypatch.setattr(mg, "VMEM_BUDGET_BYTES", SCALED_BUDGET_31)


def _run(calls, n, mom, pres, steps=STEPS):
    """The batch at n^2 over RES for ``steps`` lockstep steps from rest (an
    operator's per-case fallback under vmap an error), then each case's
    single solve: (batch, singles, the batch's calls)."""
    mesh, bc = nt.StructuredMesh(nx=n, ny=n), nt.lid_driven_cavity(1.0)
    cfg = talg.SIMPLEConfig(max_iterations=steps, tolerance=0.0)
    calls.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = talg.batched_cavity_solve(mesh, list(RES), bc, cfg, mom, pres, device="cpu")
    batch_calls = dict(calls)
    singles = [talg.simple_solve(mesh, nt.FluidProperties(density=1.0, reynolds_number=re_), bc,
                                 nt.initialize_state(mesh, bc, device="cpu"), cfg, momentum=mom,
                                 pressure=pres, loop="fused") for re_ in RES]
    return out, singles, batch_calls


def _want(per_step, out, mgcg, steps=STEPS):
    """Each kernel's batched calls (``per_step`` a step) and its single
    plain calls inside them, one a case; for MGCG, a K3 an application of
    the preconditioner (each step's slowest case's CG count + 1 batched, each
    case's own + 1 inside)."""
    want = {}
    for k, c in per_step.items():
        want[f"{k} batched"], want[k] = c * steps, c * steps * len(RES)
    if mgcg:
        counts = [[int(d.inner_iters_history[k]) for _, d in out] for k in range(steps)]
        want["K3 batched"] = sum(max(c) + 1 for c in counts)
        want["K3"] = sum(k + 1 for c in counts for k in c)
        assert len({k for c in counts for k in c}) > 1
    return want


def _held(out, singles, steps=STEPS):
    """Each case bit-equal to its single solve: iterations, every step's
    inner iterations, u, v, p, every history step and the pressure
    residual field."""
    for (bs, bd), (ss, sd) in zip(out, singles):
        assert bd.iterations == sd.iterations == steps
        for name in ("u", "v", "p"):
            assert torch.equal(getattr(bs, name), getattr(ss, name)), name
        for name in ("total_res_history", "inner_iters_history", "p_residual_field"):
            assert torch.equal(getattr(bd, name), getattr(sd, name)), name
    assert not torch.equal(out[0][0].u, out[2][0].u)


@pytest.mark.parametrize("name", list(CASES))
def test_cli_batch_takes_one_vmapped_step(odd_gates_open, monkeypatch, name):
    """``sweep --vmap <flags>`` at the grid standing for the card's: the
    vmapped branch, the exact batched calls, no ``_per_case`` step; each
    case bit-equal to its single solve."""
    calls = odd_gates_open
    n, flags, per_step = CASES[name]
    mom, pres = cli_solvers(*flags)
    _budget(monkeypatch, n, pres.kind == "mgcg")
    assert tbatch.vmap_step_ok(torch.zeros(n, n), talg.SIMPLEConfig(), mom, pres, "simple")
    out, singles, got = _run(calls, n, mom, pres)
    assert got == _want(per_step, out, pres.kind == "mgcg")
    _held(out, singles)


def test_frozen_case_rbgs(odd_gates_open):
    """A lockstep step of ``--momentum rbgs`` at 31^2 with a frozen case
    (``batch._vmapped_step``): the frozen case gets back its state and
    info, the batched K4 and K5 calls skip its plain call, and the active
    cases are bit-equal to their own single steps."""
    calls = odd_gates_open
    n = 31
    mesh, bc = nt.StructuredMesh(nx=n, ny=n), nt.lid_driven_cavity(1.0)
    dx, dy = mesh.get_cell_sizes()
    cfg = talg.SIMPLEConfig()
    mom, pres = cli_solvers("--momentum", "rbgs")
    common = dict(dx=dx, dy=dy, rho=1.0, bc=bc, cfg=cfg, mom_cfg=mom, pres_cfg=pres)
    state = nt.initialize_state(mesh, bc, device="cpu")
    single = tsimple.make_simple_step(**common, mu=1.0 / RES[0])
    u1, v1, p1, _, _ = single(state.u, state.v, state.p, tsimple.zero_carry(torch.float32, "cpu"))
    u, v, p = (torch.stack([x, x * 0.5, x * 0.25]) for x in (u1, v1, p1))
    mus = [1.0 / re_ for re_ in RES]
    visc = powerlaw.case_conductances(mus, dx, dy, torch.float32)
    extra = torch.zeros(3)
    z = torch.zeros(3)
    info = talg.base.StepInfo(z, z, z, torch.zeros(3, dtype=torch.int32), torch.zeros_like(u),
                              torch.zeros_like(v), torch.zeros_like(p))
    active = torch.tensor([True, False, True])
    step = tbatch._vmapped_step(tsimple.make_simple_step, common, visc)
    calls.clear()
    u2, v2, p2, extra2, info2 = step(u, v, p, extra, active, info)
    assert calls == {"K4 batched": 1, "K4": 2, "K5 batched": 1, "K5": 2}
    for got, old in zip((u2, v2, p2, extra2), (u, v, p, extra)):
        assert torch.equal(got[1], old[1])
    for got, old in zip(info2, info):
        assert torch.equal(got[1], old[1])
    for k in (0, 2):
        one = tsimple.make_simple_step(**common, mu=mus[k])
        want = one(u[k], v[k], p[k], extra[k])
        for g, w in zip((u2, v2, p2, extra2), want[:4]):
            assert torch.equal(g[k], w)
        assert torch.equal(info2.inner_iterations[k], want[4].inner_iterations)


def test_cli_gate_sides(odd_gates_open, monkeypatch):
    """The widened gate admits RBGS and Jacobi momentum on the odd arm and,
    where K8 refuses, on the even one; MGCG on the odd arm without K5
    (``SCALED_BUDGET`` at 63^2, V-cycles); and direct pressure on both arms.
    It still refuses MGCG with W or FMG cycles there or on the composed
    backend, direct pressure under 9-point Chebyshev momentum or the
    compensated residual, and the composed multigrid backend."""
    cfg = talg.SIMPLEConfig()

    def ok(n, *flags, mom=None, pres=None):
        m, p = cli_solvers(*flags)
        return tbatch.vmap_step_ok(torch.zeros(n, n), cfg, mom or m, pres or p, "simple")

    for n in (31, 32):
        for flags in (("--momentum", "rbgs"), ("--momentum", "jacobi"),
                      ("--pressure", "direct"), ("--pressure", "direct", "--momentum", "rbgs"),
                      ("--pressure", "direct", "--scheme", "quick")):
            assert ok(n, *flags), (n, flags)
        assert not ok(n, "--pressure", "direct", mom=ChebyshevMomentumConfig(scheme="quick"))
        assert not ok(n, "--pressure", "direct", mom=GMRESMomentumConfig(
            tolerance=1e-6, max_iterations=40, compensated_residual=True))
        assert not ok(n, "--momentum", "rbgs", pres=dataclasses.replace(
            cli_solvers()[1], backend="composed"))
    monkeypatch.setattr(mg, "VMEM_BUDGET_BYTES", SCALED_BUDGET)
    mgcg = cli_solvers("--pressure", "mgcg")[1]
    assert ok(63, "--pressure", "mgcg") and ok(63, "--pressure", "mgcg", "--momentum", "rbgs")
    assert ok(63, "--pressure", "mgcg", "--scheme", "quick")
    for cycle in ("w", "fmg"):
        assert not ok(63, pres=dataclasses.replace(
            mgcg, mg=dataclasses.replace(mgcg.mg, cycle_type=cycle))), cycle
    assert not ok(63, pres=dataclasses.replace(
        mgcg, mg=dataclasses.replace(mgcg.mg, backend="composed")))
    # a budget under which K4 takes no level: every level would be composed
    monkeypatch.setattr(mg, "VMEM_BUDGET_BYTES", 60_000)
    assert not ok(63, "--pressure", "mgcg")
