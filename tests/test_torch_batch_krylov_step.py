"""The vmapped lockstep step of ``algorithms/batch.py`` with the Krylov and
stationary loops (``solvers/krylov.py``, ``solvers/pressure.py``,
``solvers/momentum.py``'s GMRES and IDR(s)) run through
``ops/while_loop.py``, on the CPU in float32.

The kernel gates are forced open and scaled down
(``torch_batch_gates.loops_gates_open``, K7's gate shut as the 1024^2
fields find it) so that 32^2 takes the path 1024^2 takes on the card: K8's
coefficients a momentum solve, and for MGCG a K2 pair above a K3 tail an
application of the preconditioner.  Configurations: the command line's
``sweep --vmap --pressure mgcg`` under SIMPLE and PISO, GMRES and IDR(s)
momentum with the command line's default multigrid pressure, CG and RBGS
pressure.  Each takes the vmapped branch with no ``_per_case`` step, with
exact batched calls of each kernel's plain version (a cycle kernel once an
application of the slowest case, counted from the cases' own CG counts,
which also give the PCG loops' host reads), and each case bit-equal to its
single solve (the pressure loops' dots, norms and means run case by case under
``vmap``).  The odd arm at 31^2 (the command line's default 63^2 grid's
path: K7 a field, for MGCG a K4 a solve and a K3 an application) the same
way.  Then both sides of the widened gate.  (The batch against the JAX package's:
``test_torch_batch_krylov_jax.py``.)
"""

import dataclasses
import warnings

import pytest
import torch
from torch_batch_gates import (RES, _count, assembly_gates_open, close_k7,  # noqa: F401
                               gates_open, loops_gates_open)

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch.algorithms import batch as tbatch
from naviflow_tpu_torch.ops import mg, while_loop
from naviflow_tpu_torch.solvers import krylov as tk
from naviflow_tpu_torch.solvers import (CGPressureConfig, GMRESMomentumConfig,
                                        IDRSMomentumConfig, KrylovMomentumConfig,
                                        MGCGPressureConfig, MultigridConfig,
                                        RBGSPressureConfig)

torch.set_num_threads(2)

N, STEPS = 32, 3
# the command line's constructors (cli._make_solvers), --pressure-tol 1e-3
BICGSTAB = KrylovMomentumConfig(tolerance=1e-6, max_iterations=60)
MULTIGRID = MultigridConfig(tolerance=1e-3, max_cycles=30)
MGCG = MGCGPressureConfig(tolerance=1e-3, max_iterations=100)
CASES = {
    "mgcg": ("simple", BICGSTAB, MGCG),
    "mgcg_piso": ("piso", BICGSTAB, MGCG),
    "gmres_momentum": ("simple", GMRESMomentumConfig(tolerance=1e-6, max_iterations=40),
                       MULTIGRID),
    "idrs_momentum": ("simple", IDRSMomentumConfig(tolerance=1e-6), MULTIGRID),
    "cg": ("simple", BICGSTAB, CGPressureConfig(tolerance=1e-3, max_iterations=5000)),
    "rbgs": ("simple", BICGSTAB, RBGSPressureConfig(tolerance=1e-3, max_iterations=50000)),
}


def case_counts(k):
    """A loop's int32 count, case by case: under ``vmap`` read from the
    batch's own tensor."""
    if torch._C._functorch.is_batchedtensor(k):
        bdim = torch._C._functorch.maybe_get_bdim(k)
        return torch._C._functorch.get_unwrapped(k).movedim(bdim, 0).tolist()
    return [int(k)]


@pytest.fixture
def pcg_reads(monkeypatch):
    """Each loop of ``solvers/krylov.py``, appended call by call: its host
    reads and each case's own count (the loop's int32 carry).  A PCG loop
    applies its preconditioner to r0 and once an iteration: under ``vmap``
    its slowest case's count + 1 times."""
    reads = []
    real = tk.while_loop

    def wrapped(*a):
        before = while_loop.HOST_READS
        out = real(*a)
        k = next(x for x in out if x.dtype == torch.int32 and x.dim() == 0)
        reads.append((while_loop.HOST_READS - before, case_counts(k)))
        return out

    monkeypatch.setattr(tk, "while_loop", wrapped)
    return reads


def _applications(reads, solves):
    """The preconditioner applications of the batch's ``solves`` PCG loops,
    from the cases' own counts (each loop: its slowest case's + 1, the
    loop's host reads), and of the single solves inside them (every
    case's + 1)."""
    assert len(reads) == solves
    assert [r for r, _ in reads] == [max(k) + 1 for _, k in reads]
    return sum(max(k) + 1 for _, k in reads), sum(c + 1 for _, k in reads for c in k)


def _run(calls, reads, algorithm, mom, pres, n=N, steps=STEPS):
    """The batch at n^2 over RES for ``steps`` lockstep steps from rest, then
    each case's single solve: (batch, singles, the batch's calls, the PCG
    loops' host reads in the batch)."""
    mesh, bc = nt.StructuredMesh(nx=n, ny=n), nt.lid_driven_cavity(1.0)
    cfg = getattr(talg, f"{algorithm.upper()}Config")(max_iterations=steps, tolerance=0.0)
    calls.clear()
    reads.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a per-case fallback of an operator under vmap
        out = talg.batched_cavity_solve(mesh, list(RES), bc, cfg, mom, pres,
                                        algorithm=algorithm, device="cpu")
    batch_calls, batch_reads = dict(calls), list(reads)
    solve = getattr(talg, f"{algorithm}_solve")
    singles = [solve(mesh, nt.FluidProperties(density=1.0, reynolds_number=re_), bc,
                     nt.initialize_state(mesh, bc, device="cpu"), cfg, momentum=mom,
                     pressure=pres, loop="fused") for re_ in RES]
    return out, singles, batch_calls, batch_reads


def _held(out, singles, steps=STEPS):
    """Each case bit-equal to its single solve (the loops' reductions run
    case by case under ``vmap``: ``while_loop.case_by_case``)."""
    for (bs, bd), (ss, sd) in zip(out, singles):
        assert bd.iterations == sd.iterations == steps
        assert torch.equal(bd.inner_iters_history, sd.inner_iters_history)
        for name in ("u", "v", "p"):
            assert torch.equal(getattr(bs, name), getattr(ss, name)), name
        assert torch.equal(bd.total_res_history, sd.total_res_history)
    assert not torch.equal(out[0][0].u, out[2][0].u)


def _inner(out, steps=STEPS):
    """Each lockstep step's inner iterations, case by case."""
    return [[int(d.inner_iters_history[k]) for _, d in out] for k in range(steps)]


@pytest.mark.parametrize("name", list(CASES))
def test_krylov_batch_takes_one_vmapped_step(loops_gates_open, pcg_reads, monkeypatch, name):
    """Each configuration at 32^2 (1024^2's path): the vmapped branch, no
    ``_per_case`` step, the exact batched calls (K8 a momentum solve, two a
    PISO step; for MGCG a K2a / K2b / K3 call an application of the
    slowest case, each case's own applications inside them; for the
    multigrid loop one a cycle of the slowest case), each case held to its
    single solve."""
    calls = loops_gates_open
    close_k7(monkeypatch)
    algorithm, mom, pres = CASES[name]
    assert tbatch.vmap_step_ok(torch.zeros(N, N), talg.SIMPLEConfig(), mom, pres, algorithm)
    out, singles, got, reads = _run(calls, pcg_reads, algorithm, mom, pres)
    inner = _inner(out)
    k8 = 2 if algorithm == "piso" else 1
    want = {"K8 batched": k8 * STEPS, "K8": 3 * k8 * STEPS}
    if pres.kind == "mgcg":
        solves = 2 if algorithm == "piso" else 1
        lock, total = _applications(reads, solves * STEPS)
        if solves == 1:
            assert [k for _, k in reads] == [list(c) for c in inner]
        else:  # a PISO step's count is its two solves'
            assert [[x + y for x, y in zip(a, b)] for (_, a), (_, b)
                    in zip(reads[::2], reads[1::2])] == [list(c) for c in inner]
        want.update({"K2a batched": lock, "K2a": total, "K2b batched": lock, "K2b": total,
                     "K3 batched": lock, "K3": total})
    elif pres.kind == "multigrid":
        lock, total = sum(max(c) for c in inner), sum(map(sum, inner))
        want.update({"K2a batched": lock, "K2a": total, "K2b batched": lock, "K2b": total,
                     "K3 batched": lock, "K3": total})
    assert got == want
    if algorithm == "simple":  # the cases stop at their own counts
        assert len({c for step in inner for c in step}) > 1
    _held(out, singles)


# the odd arm at 31^2 (the command line's default 63^2 grid's path): K7's
# band form for both fields, or IDR(s) composed; for MGCG a K4 a solve and a
# K3 (the whole 31^2 hierarchy) an application of the preconditioner
ODD = {
    "mgcg_odd": (BICGSTAB, MGCG),
    "cg_odd": (BICGSTAB, CGPressureConfig(tolerance=1e-3, max_iterations=5000)),
    "idrs_odd": (IDRSMomentumConfig(tolerance=1e-6), MGCG),
}


@pytest.mark.parametrize("name", list(ODD))
def test_odd_krylov_batch_takes_one_vmapped_step(loops_gates_open, pcg_reads, monkeypatch,
                                                 name):
    """Each odd-arm configuration at 31^2: the vmapped branch, no
    ``_per_case`` step, the exact batched calls (K7 a field with BiCGSTAB
    momentum; for MGCG a K4 a solve and a K3 an application of the slowest
    case, from the cases' own CG counts), each case bit-equal to its single
    solve."""
    calls = loops_gates_open
    for key, fn in (("K4 batched", "galerkin_levels_batched_plain"),
                    ("K4", "galerkin_levels_plain")):
        _count(monkeypatch, calls, mg, fn, key)
    mom, pres = ODD[name]
    n = 31
    assert tbatch.vmap_step_ok(torch.zeros(n, n), talg.SIMPLEConfig(), mom, pres, "simple")
    out, singles, got, reads = _run(calls, pcg_reads, "simple", mom, pres, n=n)
    inner = _inner(out)
    want = {"K7 batched": 2 * STEPS, "K7": 6 * STEPS} if mom.kind == "bicgstab" else {}
    if pres.kind == "mgcg":
        lock, total = _applications(reads, STEPS)
        assert [k for _, k in reads] == [list(c) for c in inner]
        want.update({"K4 batched": STEPS, "K4": 3 * STEPS, "K3 batched": lock, "K3": total})
    assert got == want
    assert len({c for step in inner for c in step}) > 1
    _held(out, singles)


def test_krylov_gate_sides(loops_gates_open, monkeypatch):
    """The widened gate admits the pressure loops (CG, BiCGSTAB, GMRES,
    MGCG, Jacobi, RBGS) with either arm's momentum, GMRES and IDR(s)
    momentum on both arms, and QUICK momentum (composed); it refuses MGCG on
    the composed backend, BiCGSTAB momentum with the compensated dots, QUICK
    Chebyshev momentum, GMRES with the compensated residual and an MGCG
    hierarchy the kernels cannot take (W cycles)."""
    close_k7(monkeypatch)
    cfg = talg.SIMPLEConfig()
    p32 = torch.zeros(N, N)

    def ok(mom, pres, p=p32):
        return tbatch.vmap_step_ok(p, cfg, mom, pres, "simple")

    for _, mom, pres in CASES.values():
        assert ok(mom, pres)
    for pres in (nt.solvers.BiCGSTABPressureConfig(tolerance=1e-3),
                 nt.solvers.GMRESPressureConfig(tolerance=1e-3),
                 nt.solvers.JacobiPressureConfig(tolerance=1e-3)):
        assert ok(BICGSTAB, pres)
    composed = dataclasses.replace(MGCG, mg=dataclasses.replace(MGCG.mg, backend="composed"))
    assert not ok(BICGSTAB, composed)
    assert not ok(BICGSTAB, dataclasses.replace(MGCG, mg=dataclasses.replace(MGCG.mg,
                                                                            cycle_type="w")))
    assert not ok(dataclasses.replace(BICGSTAB, compensated_dots=True), MGCG)
    assert ok(dataclasses.replace(BICGSTAB, scheme="quick"), MGCG)
    assert not ok(nt.solvers.ChebyshevMomentumConfig(scheme="quick"), MGCG)
    assert not ok(GMRESMomentumConfig(compensated_residual=True), MGCG)
    # the odd arm: K7 for both fields, GMRES or IDR(s) composed (BiCGSTAB
    # with the multigrid is K6's step)
    p31 = torch.zeros(31, 31)
    from naviflow_tpu_torch.ops import krylov

    monkeypatch.setattr(krylov, "MAX_FIELD_BYTES", 2**20)
    for mom in (BICGSTAB, GMRESMomentumConfig(), IDRSMomentumConfig()):
        assert ok(mom, CGPressureConfig(tolerance=1e-3), p=p31)
        assert ok(mom, MGCG, p=p31) and ok(mom, MULTIGRID, p=p31) == (mom.kind != "bicgstab")


@pytest.mark.parametrize("pres", [dataclasses.replace(MGCG, mg=dataclasses.replace(
    MGCG.mg, backend="composed")), dataclasses.replace(MGCG, mg=dataclasses.replace(
        MGCG.mg, cycle_type="w"))], ids=["mgcg_composed", "mgcg_w_cycles"])
def test_refused_steps_case_by_case(loops_gates_open, monkeypatch, pres):
    """MGCG on the composed backend and with W cycles (gates open) step
    case by case, as QUICK momentum with the compensated residual does; so
    does the CPU device with the gates closed
    (``test_cpu_steps_case_by_case``)."""
    seen = []
    real = tbatch._per_case
    monkeypatch.setattr(tbatch, "_per_case", lambda steps: seen.append(len(steps)) or real(steps))
    mesh, bc = nt.StructuredMesh(nx=16, ny=16), nt.lid_driven_cavity(1.0)
    talg.batched_cavity_solve(mesh, [100.0, 400.0], bc, talg.SIMPLEConfig(max_iterations=2),
                              BICGSTAB, pres, device="cpu")
    talg.batched_cavity_solve(mesh, [100.0, 400.0], bc, talg.SIMPLEConfig(max_iterations=2),
                              dataclasses.replace(BICGSTAB, scheme="quick",
                                                  compensated_residual=True), MGCG, device="cpu")
    assert seen == [2, 2]


def test_cpu_steps_case_by_case(monkeypatch):
    """On the CPU (gates closed) MGCG pressure and IDR(s) momentum step case
    by case."""
    seen = []
    real = tbatch._per_case
    monkeypatch.setattr(tbatch, "_per_case", lambda steps: seen.append(len(steps)) or real(steps))
    mesh, bc = nt.StructuredMesh(nx=16, ny=16), nt.lid_driven_cavity(1.0)
    for mom, pres in ((BICGSTAB, MGCG), (IDRSMomentumConfig(tolerance=1e-6), MULTIGRID)):
        talg.batched_cavity_solve(mesh, [100.0, 400.0], bc,
                                  talg.SIMPLEConfig(max_iterations=2), mom, pres, device="cpu")
    assert seen == [2, 2]
