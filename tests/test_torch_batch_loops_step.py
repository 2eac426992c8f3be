"""The vmapped lockstep step of ``algorithms/batch.py`` with the loops that
read the host (BiCGSTAB momentum, the multigrid tolerance loop) run through
``ops/while_loop.py``, on the CPU.

The kernel gates are forced open and scaled down (``torch_batch_gates``):
(a) the command line's default solver at 32^2 as at 256^2 on the card (K7
a field, K5 the whole pressure solve); (b) the same with K7's gate shut, as
at 1024^2 (K8's coefficients, the pair loop, a K2 pair above a K3 tail a
cycle until the tolerance); (c) ``bench.py``'s sequenced configuration the
same way; (d) the FMG headline at 31^2 as at 255^2 (K7, K5, K4).  Each
takes the vmapped branch with no ``_per_case`` step, one batched call of
each kernel's plain version a kernel launch of the lockstep step (the
loops' kernels once an iteration for every case still iterating), and in
float32 each case is bit-equal to its single solve.  Then each side of the
widened gates, and the batched grid K7's C slots through a recording
library.  (The batch against the JAX package's: ``test_torch_batch_loops_jax.py``.)
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch
from torch_batch_gates import (RES, assembly_gates_open, close_k7, gates_open,  # noqa: F401
                               loops_gates_open, open_k5)

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch.algorithms import batch as tbatch
from naviflow_tpu_torch.ops import _cuda, assembly, krylov, while_loop
from naviflow_tpu_torch.ops.stencil import StencilCoeffs
from naviflow_tpu_torch.solvers import momentum as tmom
from naviflow_tpu_torch.solvers.momentum import KrylovMomentumConfig
from naviflow_tpu_torch.solvers.multigrid import MultigridConfig

torch.set_num_threads(2)

STEPS = 4
# the command line's default solvers (cli._make_solvers)
CLI = (KrylovMomentumConfig(tolerance=1e-6, max_iterations=60),
       MultigridConfig(tolerance=1e-3, max_cycles=30))
# bench.py's sequenced configuration (chip_smoke.sequenced_configs)
SEQ = (KrylovMomentumConfig(tolerance=1e-6, max_iterations=25),
       MultigridConfig(tolerance=1e-2, max_cycles=8, cycle_type="v", check_every=2,
                       coarsest_sweeps=32, coarse_rebuild_every=8))
# the FMG headline (chip_smoke.headline_configs(cycle_type="fmg"))
FMG = (KrylovMomentumConfig(tolerance=1e-6, max_iterations=20),
       MultigridConfig(tolerance=1e-2, max_cycles=6, cycle_type="fmg", check_every=2,
                       coarsest_sweeps=8, coarse_rebuild_every=8))


def _real_k8_gate(monkeypatch):
    """K8's own gate (from 384^2): the 256^2 fields assemble composed."""
    monkeypatch.setattr(tmom, "supports_fused_assembly", assembly.supports_fused_assembly)
    monkeypatch.setattr(tbatch, "supports_fused_assembly", assembly.supports_fused_assembly)


def _run(calls, n, configs, steps=STEPS):
    """The batch of ``configs`` at n^2 over RES for ``steps`` lockstep steps
    from rest, then each case's single solve: (batch, singles, the batch's
    calls, the loops' host reads in the batch and in the single solves)."""
    mesh, bc = nt.StructuredMesh(nx=n, ny=n), nt.lid_driven_cavity(1.0)
    cfg = talg.SIMPLEConfig(max_iterations=steps, tolerance=0.0)
    calls.clear()
    while_loop.HOST_READS = 0
    out = talg.batched_cavity_solve(mesh, list(RES), bc, cfg, *configs, device="cpu")
    batch_calls, reads = dict(calls), while_loop.HOST_READS
    singles = [talg.simple_solve(mesh, nt.FluidProperties(density=1.0, reynolds_number=re_), bc,
                                 nt.initialize_state(mesh, bc, device="cpu"), cfg,
                                 momentum=configs[0], pressure=configs[1], loop="fused")
               for re_ in RES]
    return out, singles, batch_calls, (reads, while_loop.HOST_READS - reads)


def _bit_equal(out, singles, steps=STEPS):
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


def test_cli_default_even_k7_k5(loops_gates_open, monkeypatch):
    """(a) The command line's default at 32^2 (256^2 on the card): each
    lockstep step two batched K7 calls (u, v) and one batched K5 call, no
    ``_per_case`` step; each case bit-equal to its single solve."""
    calls = loops_gates_open
    open_k5(monkeypatch)
    _real_k8_gate(monkeypatch)
    out, singles, got, _ = _run(calls, 32, CLI)
    assert got == {"K7 batched": 2 * STEPS, "K7": 6 * STEPS, "K5 batched": STEPS,
                   "K5": 3 * STEPS}
    _bit_equal(out, singles)


@pytest.mark.parametrize("configs", [CLI, SEQ], ids=["cli", "sequenced"])
def test_even_pair_loop_and_tolerance_cycles(loops_gates_open, monkeypatch, configs):
    """(b) The command line's default and (c) the sequenced configuration
    at 32^2 with K7's gate shut (1024^2 on the card): each lockstep step
    one batched K8 call, the pair loop through the loop primitive, and a
    batched K2a / K2b / K3 call a cycle of the slowest case (each case's
    own cycles inside them); no ``_per_case`` step; each case bit-equal to
    its single solve, whose pressure cycles vary from step to step and from
    case to case; the loops' host reads fewer than the single solves'."""
    calls = loops_gates_open
    close_k7(monkeypatch)
    out, singles, got, (reads, single_reads) = _run(calls, 32, configs)
    cycles = _cycles(out)
    lock = sum(max(c) for c in cycles)
    total = sum(sum(c) for c in cycles)
    assert got == {"K8 batched": STEPS, "K8": 3 * STEPS, "K2a batched": lock, "K2a": total,
                   "K2b batched": lock, "K2b": total, "K3 batched": lock, "K3": total}
    assert len({c for step in cycles for c in step}) > 1
    _bit_equal(out, singles)
    assert 0 < reads < single_reads


def test_fmg_headline_odd_k7_k5_k4(loops_gates_open):
    """(d) The FMG headline at 31^2 (255^2 on the card, K7's grid form):
    each lockstep step two batched K7 calls and one batched K5, a batched
    K4 at each hierarchy refresh; no ``_per_case`` step; each case
    bit-equal to its single solve."""
    calls = loops_gates_open
    from naviflow_tpu_torch.ops import mg

    real = (mg.galerkin_levels_batched_plain, mg.galerkin_levels_plain)
    counted = {"K4 batched": 0, "K4": 0}

    def wrap(fn, key):
        def inner(*a, **k):
            counted[key] += 1
            return fn(*a, **k)
        return inner

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mg, "galerkin_levels_batched_plain", wrap(real[0], "K4 batched"))
        mp.setattr(mg, "galerkin_levels_plain", wrap(real[1], "K4"))
        out, singles, got, _ = _run(calls, 31, FMG)
    assert got == {"K7 batched": 2 * STEPS, "K7": 6 * STEPS, "K5 batched": STEPS,
                   "K5": 3 * STEPS}
    assert counted["K4 batched"] == 1
    _bit_equal(out, singles)


def test_loops_gate_sides(loops_gates_open, monkeypatch):
    """The widened gates: the even arm admits BiCGSTAB momentum (K7 a
    field, or the pair loop or the single-field loop) and a pressure
    tolerance (K5, or the strips and the tail in the loop primitive,
    either layout); it refuses the compensated dots, the composed backend,
    GMRES and IDR(s) momentum, W and FMG cycles and the compensated
    residual; the odd arm keeps its rule (K7, K5 and K4 for the FMG
    headline; the command line's default on an odd grid past K5's budget
    steps case by case)."""
    cfg = talg.SIMPLEConfig()
    p32 = torch.zeros(32, 32)

    def ok(mom, pres, p=p32):
        return tbatch.vmap_step_ok(p, cfg, mom, pres, "simple")

    mom, pres = CLI
    assert ok(mom, pres) and ok(*SEQ)
    assert ok(dataclasses.replace(mom, batch_pair="off"), pres)
    assert ok(mom, dataclasses.replace(pres, fine_layout="plane"))
    close_k7(monkeypatch)
    assert ok(mom, pres) and ok(dataclasses.replace(mom, batch_pair="off"), pres)
    assert not ok(dataclasses.replace(mom, compensated_dots=True), pres)
    assert not ok(dataclasses.replace(mom, backend="composed"), pres)
    assert not ok(dataclasses.replace(mom, compensated_residual=True), pres)
    assert not ok(tmom.GMRESMomentumConfig(), pres)
    assert not ok(tmom.IDRSMomentumConfig(), pres)
    assert not ok(mom, dataclasses.replace(pres, cycle_type="w"))
    assert not ok(mom, dataclasses.replace(pres, cycle_type="fmg"))
    monkeypatch.setattr(krylov, "MAX_FIELD_BYTES", 2**20)
    assert ok(*FMG, p=torch.zeros(31, 31))
    assert not ok(*CLI, p=torch.zeros(511, 511))  # K5 cannot take the whole solve


def test_loops_gate_closed_on_cpu_steps_case_by_case(monkeypatch):
    """On the CPU (gates closed) the command line's default steps case by
    case."""
    seen = []
    real = tbatch._per_case
    monkeypatch.setattr(tbatch, "_per_case", lambda steps: seen.append(len(steps)) or real(steps))
    mesh, bc = nt.StructuredMesh(nx=16, ny=16), nt.lid_driven_cavity(1.0)
    talg.batched_cavity_solve(mesh, [100.0, 400.0], bc, talg.SIMPLEConfig(max_iterations=2),
                              *CLI, device="cpu")
    assert seen and set(seen) == {2}


# ---------------------------------------------------------------------------
# the batched grid K7's C entry

CSRC = Path(krylov.__file__).resolve().parent.parent / "csrc"


class _Recorder:
    def __init__(self):
        self.calls = []

    def _record(self, name, ptrs, ip, fp, stream):
        self.calls.append((name, list(ptrs), list(ip), list(fp), stream))
        return 0

    def nf_bicgstab_batched(self, *a):
        return self._record("nf_bicgstab_batched", *a)

    def nf_bicgstab_grid_batched(self, *a):
        return self._record("nf_bicgstab_grid_batched", *a)


def _body(src, signature):
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


def test_grid_batched_slots_match_c_entry(monkeypatch):
    """``nf_bicgstab_grid_batched`` reads nf_bicgstab's nine slots for case 0
    through ``kg_read`` (nf_bicgstab's own grid reads), the active flags,
    then the ten slots' strides (the scratch's in slot 18, which also moves
    each case's partials), B after the eight integers, band 0 only; it and
    the single grid launch go through ``kg_launch``, at most
    ``KG_BLOCKS_PER_SM`` blocks an SM, both kernels bound to keep as many
    resident, so their block counts are equal.  The wrapper (a field
    past the band's shared memory: 256 x 255) fills the addresses and
    strides, one scratch of B single scratches kept across calls, one
    output; a band-sized field still takes ``nf_bicgstab_batched``."""
    src = (CSRC / "krylov.cu").read_text()
    entry = _body(src, "NF_EXPORT int nf_bicgstab_grid_batched(")
    assert "kg_read(Q.K, Q.red, ptrs, ip);" in entry
    assert "kg_read(Q.S, red_stride, ptrs + 10, ip);" in entry
    assert "reinterpret_cast<float*>(ptrs[18])" in entry
    assert "Q.red_stride = reinterpret_cast<const float*>(ptrs[18]);" in entry
    assert "Q.active = reinterpret_cast<const bool*>(ptrs[9]);" in entry
    assert "Q.active_stride = reinterpret_cast<const bool*>(ptrs[19]);" in entry
    assert "Q.cases = ip[8];" in entry and "ip[7]" in entry
    assert "kg_launch(bicgstab_grid_kernel_batched, P, ip[0], ip[1]," in entry
    single = _body(src, "NF_EXPORT int nf_bicgstab(")
    assert "kg_read(P.K, P.red, ptrs, ip);" in single
    assert "kg_launch(bicgstab_grid_kernel, P, ni, nj, 0," in single
    assert "nf_coop_blocks(kernel, (int64_t)ni * nj, blocks, smem, KG_BLOCKS_PER_SM)" in \
        _body(src, "int kg_launch(")
    for kernel in ("bicgstab_grid_kernel(", "bicgstab_grid_kernel_batched("):
        assert f"__launch_bounds__(NF_THREADS, KG_BLOCKS_PER_SM)\n    {kernel}" in src
    read = _body(src, "void kg_read(")
    assert "K.x0 = reinterpret_cast<const float*>(ptrs[0]);" in read
    assert "reinterpret_cast<const float*>(ptrs[1 + k])" in read
    assert "K.x = reinterpret_cast<float*>(ptrs[7]);" in read
    assert "reinterpret_cast<float*>(ptrs[8])" in read and "red = scratch + 6 * n;" in read
    fields = re.findall(r"float\*\* vecs\[\] = \{([^}]*)\}", read)[0]
    assert [f.strip()[3:] for f in fields.split(",")] == list(krylov.GRID_VECTORS)

    lib = _Recorder()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_of", lambda x: 7)
    monkeypatch.setattr(_cuda, "kernel_device", lambda x: True)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(krylov, "cluster_size", lambda device=None: 16)
    monkeypatch.setattr(krylov, "_BATCH", {})
    for name in ("BATCH_LAUNCHES", "GRID_BATCH_LAUNCHES"):
        monkeypatch.setattr(krylov, name, 0)
    cases, shape = 3, (256, 255)
    x0 = torch.zeros(cases, *shape)
    shared = torch.zeros(shape)
    c = StencilCoeffs(*[torch.zeros(cases, *shape) for _ in range(5)],
                      shared.expand(cases, *shape))
    active = torch.tensor([True, False, True])
    out1 = krylov.bicgstab_momentum_batched(x0, c, tol=1e-6, maxiter=60, active=active)
    out2 = krylov.bicgstab_momentum_batched(x0, c, tol=1e-6, maxiter=60)
    krylov.bicgstab_momentum_batched(torch.zeros(cases, 64, 63),
                                     StencilCoeffs(*[torch.zeros(cases, 64, 63)] * 6),
                                     tol=1e-6, maxiter=60)
    (e1, p1, ip1, fp1, s1), (e2, p2, ip2, _, _), (e3, _, ip3, _, _) = lib.calls
    assert e1 == e2 == "nf_bicgstab_grid_batched" and e3 == "nf_bicgstab_batched"
    assert s1 == 7 and fp1 == pytest.approx([1e-6])
    assert ip1 == ip2 == [256, 255, 60, 1, 1, 1, 1, 0, cases] and ip3[7] == 1
    arrays = [x0, c.a_e, c.a_w, c.a_n, c.a_s, c.a_p, c.src]
    assert p1[:7] == [a.data_ptr() for a in arrays] and p1[7] == out1.data_ptr()
    st = krylov._BATCH[(torch.device("cpu"), 7, shape, 60, (1, 1, 1, 1), 1e-6, cases)]
    per_case = krylov.grid_scratch_floats(shape)
    assert st.scratch.shape == (cases, per_case)
    assert p1[8] == p2[8] == st.scratch.data_ptr() != 0 and p1[18] == 4 * per_case
    assert p1[9] == active.data_ptr() and p1[19] == 1 and p2[9] != p1[9]
    assert p1[10:16] == [4 * 256 * 255] * 6 and p1[16] == 0 and p1[17] == 4 * 256 * 255
    assert p2[7] == out2.data_ptr() != p1[7]
    assert krylov.BATCH_LAUNCHES == 3 and krylov.GRID_BATCH_LAUNCHES == 2
