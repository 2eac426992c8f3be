"""The vmapped lockstep step of ``algorithms/batch.py`` with 9-point momentum
(QUICK, LUDS, upwind) and on odd grids whose whole pressure solve K5 cannot
take, on the CPU in float32.

The kernel gates are forced open (``torch_batch_gates.loops_gates_open``)
so that a small grid takes the path a large one takes on the card, with
the command line's solvers (``cli._make_solvers``: BiCGSTAB momentum to
1e-6 in at most 60 iterations, multigrid to 1e-3 in at most 30 cycles):

* ``sweep --vmap --scheme quick|luds|upwind`` at 31^2, the odd arm as at
  the command line's default 63^2: the 9-point momentum composed (its
  BiCGSTAB the single-field loop through ``ops/while_loop.py``), a K4 and a
  K5 a step;
* QUICK at 32^2, the even arm as at 256^2: a K5 a step;
* power-law and QUICK at 63^2 with the multigrid budget scaled down
  (``SCALED_BUDGET``) so that K5 refuses the whole solve and K4's gate
  opens at level 1 only, the path of ``sweep --vmap --nx 511`` on the card:
  the 63^2 -> 31^2 level coarsened composed, K4 from the 9-point 31^2
  level, V-cycles whose fine level is composed and whose 31^2 -> 7^2 tail
  is a K3 (power-law momentum: K7 a field).

Each takes the vmapped branch with no ``_per_case`` step, one batched call
of each kernel's plain version a launch of the lockstep step (a cycle
kernel once a cycle of the slowest case), each case's own single calls
inside them, and each case bit-equal to its single solve in u, v, p, every
history step and every step's inner iterations (the loops' dots, norms and
means run case by case under ``vmap``).  Then both sides of the widened
gate, a lockstep step with a frozen case, and the 9-point assembly with a
case's conductance row.  (The batch against the JAX package's:
``test_torch_batch_highorder_jax.py``.)
"""

import dataclasses
import warnings

import pytest
import torch
from torch_batch_gates import (RES, SCALED_BUDGET, assembly_gates_open, gates_open,  # noqa: F401
                               loops_gates_open, odd_gates_open, open_k5)

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch.algorithms import batch as tbatch
from naviflow_tpu_torch.algorithms import simple as tsimple
from naviflow_tpu_torch.ops import highorder, mg, powerlaw
from naviflow_tpu_torch.solvers import (GMRESMomentumConfig, IDRSMomentumConfig,
                                        JacobiMomentumConfig, KrylovMomentumConfig,
                                        MultigridConfig, RBGSMomentumConfig)
from naviflow_tpu_torch.solvers.momentum import ChebyshevMomentumConfig

torch.set_num_threads(2)

STEPS = 3
# the command line's constructors (cli._make_solvers), --pressure-tol 1e-3
BICGSTAB = KrylovMomentumConfig(tolerance=1e-6, max_iterations=60)
MULTIGRID = MultigridConfig(tolerance=1e-3, max_cycles=30)


def _quick(scheme="quick", mom=BICGSTAB):
    return dataclasses.replace(mom, scheme=scheme)


def _run(calls, n, mom, pres=MULTIGRID, steps=STEPS):
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


def _cycles(out, steps=STEPS):
    """Each lockstep step's pressure cycles, case by case."""
    return [[int(d.inner_iters_history[k]) for _, d in out] for k in range(steps)]


def _batched(per_step, steps=STEPS):
    """Each kernel's batched calls (``per_step`` of them a step) and its
    single plain calls inside them, one a case."""
    out = {}
    for k, c in per_step.items():
        out[f"{k} batched"], out[k] = c * steps, c * steps * len(RES)
    return out


@pytest.mark.parametrize("scheme", ["quick", "luds", "upwind"])
def test_nine_point_odd_arm_k5_k4(odd_gates_open, scheme):
    """``sweep --vmap --scheme <scheme>`` at 31^2 (the default 63^2's path):
    a batched K4 and K5 a lockstep step, no K7 (it refuses 9-point
    systems), no ``_per_case`` step; each case bit-equal to its single
    solve."""
    calls = odd_gates_open
    mom = _quick(scheme)
    assert tbatch.vmap_step_ok(torch.zeros(31, 31), talg.SIMPLEConfig(), mom, MULTIGRID, "simple")
    out, singles, got = _run(calls, 31, mom)
    assert got == _batched({"K4": 1, "K5": 1})
    _held(out, singles)


def test_quick_even_arm_k5(loops_gates_open, monkeypatch):
    """``sweep --vmap --nx 256 --scheme quick``'s path at 32^2 (K5's budget
    the card's): a batched K5 a lockstep step, nothing else batched, no
    ``_per_case`` step; each case bit-equal to its single solve."""
    calls = loops_gates_open
    open_k5(monkeypatch)
    mom = _quick()
    assert tbatch.vmap_step_ok(torch.zeros(32, 32), talg.SIMPLEConfig(), mom, MULTIGRID, "simple")
    out, singles, got = _run(calls, 32, mom)
    assert got == _batched({"K5": 1})
    _held(out, singles)


@pytest.mark.parametrize("scheme", ["power_law", "quick"])
def test_odd_arm_without_k5(odd_gates_open, monkeypatch, scheme):
    """``sweep --vmap --nx 511 [--scheme quick]``'s path at 63^2
    (``SCALED_BUDGET``): K5 refuses the whole solve; a batched K4 a lockstep
    step from the 9-point 31^2 level (63^2 -> 31^2 composed), a batched K3
    a cycle of the slowest case on the 31^2 -> 7^2 tail (each case's own
    cycles inside), for power-law momentum two batched K7 calls; no K5, no
    ``_per_case`` step; each case bit-equal to its single solve."""
    calls = odd_gates_open
    monkeypatch.setattr(mg, "VMEM_BUDGET_BYTES", SCALED_BUDGET)
    mom = _quick(scheme)
    p = torch.zeros(63, 63)
    assert not mg.supports_fused_rap(63, 63, MULTIGRID, torch.float32)
    assert mg.supports_fused_rap(31, 31, MULTIGRID, torch.float32)
    assert tbatch.vmap_step_ok(p, talg.SIMPLEConfig(), mom, MULTIGRID, "simple")
    out, singles, got = _run(calls, 63, mom)
    cycles = _cycles(out)
    lock, total = sum(max(c) for c in cycles), sum(map(sum, cycles))
    want = _batched({"K4": 1} if scheme == "quick" else {"K4": 1, "K7": 2})
    want.update({"K3 batched": lock, "K3": total})
    assert got == want
    _held(out, singles)


def test_highorder_gate_sides(odd_gates_open, monkeypatch):
    """The widened gate admits 9-point BiCGSTAB, GMRES, IDR(s), Jacobi and
    red-black GS momentum on both arms and the odd arm without K5 (V-cycles,
    with or without a pressure tolerance); it refuses 9-point Chebyshev,
    the compensated residual and dots, the composed backend (of the
    momentum and of the multigrid), W and FMG cycles where K5 cannot take
    the solve, and a hierarchy that K4 takes nowhere."""
    cfg = talg.SIMPLEConfig()

    def ok(mom, pres=MULTIGRID, n=31):
        return tbatch.vmap_step_ok(torch.zeros(n, n), cfg, mom, pres, "simple")

    nine = [_quick(s, m) for s in ("quick", "luds", "upwind")
            for m in (BICGSTAB, GMRESMomentumConfig(tolerance=1e-6), IDRSMomentumConfig(),
                      JacobiMomentumConfig(n_sweeps=2), RBGSMomentumConfig(n_sweeps=2))]
    for n in (31, 32):
        for mom in nine:
            assert ok(mom, n=n), (mom, n)
        assert ok(_quick(), dataclasses.replace(MULTIGRID, tolerance=0.0, max_cycles=2), n=n)
        for mom in (_quick(mom=ChebyshevMomentumConfig()),
                    _quick(mom=dataclasses.replace(BICGSTAB, compensated_residual=True)),
                    _quick(mom=dataclasses.replace(BICGSTAB, compensated_dots=True)),
                    _quick(mom=dataclasses.replace(BICGSTAB, backend="composed"))):
            assert not ok(mom, n=n), (mom, n)
        assert not ok(_quick(), dataclasses.replace(MULTIGRID, backend="composed"), n=n)
    # the odd arm without K5 (63^2 as 511^2)
    monkeypatch.setattr(mg, "VMEM_BUDGET_BYTES", SCALED_BUDGET)
    for mom in (BICGSTAB, _quick()):
        assert ok(mom, n=63)
        assert ok(mom, dataclasses.replace(MULTIGRID, tolerance=0.0, max_cycles=2), n=63)
        for cycle in ("w", "fmg"):
            assert not ok(mom, dataclasses.replace(MULTIGRID, cycle_type=cycle), n=63), cycle
        assert not ok(mom, dataclasses.replace(MULTIGRID, backend="composed"), n=63)
        assert not ok(mom, dataclasses.replace(MULTIGRID, coarsening="rediscretize"), n=63)
    # a budget under which K4 takes no level: every level would be composed
    monkeypatch.setattr(mg, "VMEM_BUDGET_BYTES", 60_000)
    assert not ok(_quick(), n=63)


@pytest.mark.parametrize("pres,n", [(dataclasses.replace(MULTIGRID, cycle_type="w"), 63),
                                    (dataclasses.replace(MULTIGRID, cycle_type="fmg"), 63)],
                         ids=["w_cycles", "fmg_cycles"])
def test_refused_steps_stay_case_by_case(odd_gates_open, monkeypatch, pres, n):
    """With the gates open, W and FMG cycles on the odd arm without K5
    (63^2 at ``SCALED_BUDGET``) under QUICK momentum step case by case
    (``_per_case``), with no batched call."""
    calls = odd_gates_open
    monkeypatch.setattr(mg, "VMEM_BUDGET_BYTES", SCALED_BUDGET)
    mesh, bc = nt.StructuredMesh(nx=n, ny=n), nt.lid_driven_cavity(1.0)
    calls.clear()
    talg.batched_cavity_solve(mesh, [100.0, 400.0], bc, talg.SIMPLEConfig(max_iterations=1),
                              _quick(), pres, device="cpu")
    assert calls["per case"] >= 1 and not any(k.endswith("batched") for k in calls)


def test_frozen_case_without_k5(odd_gates_open, monkeypatch):
    """A lockstep step of the odd arm without K5 (QUICK, 63^2 at
    ``SCALED_BUDGET``) with a frozen case (``batch._vmapped_step``): the
    frozen case gets back its state and info, the batched K4 and K3 calls
    skip its plain call, and the active cases are bit-equal to their own
    single steps."""
    calls = odd_gates_open
    monkeypatch.setattr(mg, "VMEM_BUDGET_BYTES", SCALED_BUDGET)
    n = 63
    mesh, bc = nt.StructuredMesh(nx=n, ny=n), nt.lid_driven_cavity(1.0)
    dx, dy = mesh.get_cell_sizes()
    cfg, mom = talg.SIMPLEConfig(), _quick()
    common = dict(dx=dx, dy=dy, rho=1.0, bc=bc, cfg=cfg, mom_cfg=mom, pres_cfg=MULTIGRID)
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
    cycles = [int(info2.inner_iterations[k]) for k in (0, 2)]
    assert calls == {"K4 batched": 1, "K4": 2, "K3 batched": max(cycles), "K3": sum(cycles)}
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nine_point_assembly_takes_a_conductance_row(dtype):
    """The 9-point u and v assembly with one case's conductance row
    (``powerlaw.case_conductances``, as under the vmapped step) is bit-equal
    to the assembly with the number ``mu`` (as in the single solve), for
    each scheme; and under ``torch.func.vmap`` over the rows, each case's is
    its single one's."""
    n = 15
    g = torch.Generator().manual_seed(0)
    u = torch.randn((n + 1, n), generator=g, dtype=torch.float64).to(dtype)
    v = torch.randn((n, n + 1), generator=g, dtype=torch.float64).to(dtype)
    p = torch.randn((n, n), generator=g, dtype=torch.float64).to(dtype)
    dx = dy = 1.0 / n
    mus = [1.0 / re_ for re_ in RES]
    rows = powerlaw.case_conductances(mus, dx, dy, dtype)
    for scheme in highorder.SCHEME_WEIGHTS:
        for fn in (highorder.u_momentum_coefficients9, highorder.v_momentum_coefficients9):
            kw = dict(dx=dx, dy=dy, rho=1.0, scheme=scheme)

            def fields(c):
                return [getattr(c, f.name) for f in dataclasses.fields(c)]

            batched = torch.func.vmap(lambda row: tuple(fields(fn(u, v, p, mu=row, **kw))))(rows)
            for k, mu in enumerate(mus):
                want = fields(fn(u, v, p, mu=mu, **kw))
                for a, b, c in zip(fields(fn(u, v, p, mu=rows[k], **kw)), want, batched):
                    assert torch.equal(a, b) and torch.equal(c[k], b), (scheme, fn.__name__)
