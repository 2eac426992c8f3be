"""K6's case axis on the CPU, the part of ``tests/test_torch_batch_fused.py``
that needs no JAX program: (c) with the kernel gates forced open at 15^2,
``batched_cavity_solve`` runs one batched K6 call a lockstep step and K4
once a batch, each case bit-equal to its single solve; (d) the batched C
entry's slots and case strides against the wrapper's, through a library
that records its calls.  (A file of its own so that the test workers share
the long runs.)
"""

import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import algorithms as talg
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops import _cuda, krylov, mg, step

from test_torch_batch_fused import BODIES, CSRC, MOM, MUS, PRES, _port_kw

torch.set_num_threads(2)


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

    count(step, "fused_outer_step_batched_plain", "K6 batched")
    count(step, "fused_outer_step_plain", "K6")
    count(mg, "galerkin_levels_plain", "K4")
    count(mg, "fused_mg_solve_plain", "K5")
    count(krylov, "bicgstab_momentum_plain", "K7")
    count(mg, "fused_vcycle_plain", "K3")
    return calls


@pytest.mark.parametrize("algo", ["simple", "simplec", "piso", "simpler"])
def test_gates_open_one_batched_k6_a_lockstep_step(kernel_gates_open, algo):
    """With the gates open the headline configuration at 15^2, Re 100 / 400
    / 1000 to 1e-3, runs one batched K6 call a lockstep step (the cases'
    largest count), each case's single step inside it once a step of that
    case, K4 once a batch (the lagged carry's setup hierarchy, shared) and
    nothing else; each case bit-equal to its single solve, whose own path
    is one K6 a step."""
    calls = kernel_gates_open
    cfg_cls = {"simple": talg.SIMPLEConfig, "simplec": talg.SIMPLECConfig,
               "piso": talg.PISOConfig, "simpler": talg.SIMPLERConfig}[algo]
    solve = {"simple": talg.simple_solve, "simplec": talg.simplec_solve,
             "piso": talg.piso_solve, "simpler": talg.simpler_solve}[algo]
    mesh, bc = nt.StructuredMesh(nx=15, ny=15), nt.lid_driven_cavity(1.0)
    cfg = cfg_cls(max_iterations=300, tolerance=1e-3)
    mom, pres = interop.config(MOM), interop.config(PRES)
    res = [100.0, 400.0, 1000.0]
    out = talg.batched_cavity_solve(mesh, res, bc, cfg, mom, pres, algorithm=algo,
                                    device="cpu")
    iters = [d.iterations for _, d in out]
    assert all(d.converged for _, d in out)
    assert calls == {"K6 batched": max(iters), "K6": sum(iters), "K4": 1}
    for re_, (bs, bd) in zip(res, out):
        calls.clear()
        ss, sd = solve(mesh, nt.FluidProperties(density=1.0, reynolds_number=re_), bc,
                       nt.initialize_state(mesh, bc, device="cpu"), cfg, momentum=mom,
                       pressure=pres, loop="fused")
        assert calls == {"K6": sd.iterations, "K4": 1}
        assert bd.iterations == sd.iterations
        for name in ("u", "v", "p"):
            assert torch.equal(getattr(bs, name), getattr(ss, name)), name
        for name in ("total_res_history", "inner_iters_history", "p_residual_field"):
            assert torch.equal(getattr(bd, name), getattr(sd, name)), name
    assert len(set(iters)) > 1


def _c_batched_reads():
    """The pointers ``launch_step`` (csrc/step.cuh) reads only batched, in
    order, and the pointer fields of ``StepParams``."""
    src = (CSRC / "step.cuh").read_text()
    body = src[src.index("int launch_step("):]
    block = body[body.index("if (BATCH) {"):]
    block = block[:block.index("}")]
    reads = re.findall(r"(P\.\w+) = (?:reinterpret_cast<[^>]+>\()?next\(\)", block)
    params = src[src.index("struct StepParams {"):]
    params = params[:params.index("};")]
    fields = re.findall(r"\*\s*(\w+)(\[\d+\])?", params)
    case = src[src.index("void step_case("):]
    case = case[:case.index("\n}\n")]
    return src, reads, fields, case


# the C targets of the batched reads -> the wrapper's slot names
C_BATCHED = {"P.sc_held": "scalars_held", "P.ru_held": "r_u_held", "P.rv_held": "r_v_held",
             "P.rp_held": "r_p_held", "P.cyc_held": "cycles_held", "P.active": "active",
             "P.visc": "visc"}


class _Recorder:
    """Records the batched K6 C entry's pointer, int and float arrays."""

    def __init__(self):
        self.calls = []

    def nf_fused_outer_step_batched(self, ptrs, ip, fp, stream):
        self.calls.append((list(ptrs), list(ip), list(fp), stream))
        return 0


@pytest.mark.parametrize("algo", ["simple", "simplec"])
def test_k6_batched_layout_matches_c_entry(monkeypatch, algo):
    """The batched slots (``batched_launch_slots``) against the C entry:
    its batched reads follow the single launch's slots in the wrapper's
    order, a second pass reads the strides, ``step_case`` moves every
    per-case pointer field of ``StepParams`` (all but the phase timers),
    and the case count follows the level shapes.  Through a recording
    library, at 15^2 (one level in global memory) and 31^2, B = 3: the
    addresses then the byte strides of every slot (the inputs' own strides,
    the scalar carries a strided view of the last results), scratch reused
    across calls, the outputs one buffer with each output's cases
    contiguous, ``ip`` the single launch's with B appended, ``(De, Dn)`` each
    case's single-launch float32 values."""
    src, reads, fields, case = _c_batched_reads()
    assert "pass < (BATCH ? 2 : 1)" in src and "ip[22 + 2 * SB.P.M.L]" in src
    n_single = None
    for n, coarsest in ((15, 3), (31, 3)):
        pres = dataclasses.replace(interop.config(PRES), coarsest_grid_size=coarsest)
        shapes = step.step_shapes(n, n, pres)
        single = step.launch_slots(algo, n, n, shapes)
        slots = step.batched_launch_slots(algo, n, n, shapes)
        assert slots[:len(single)] == single
        assert [name for name, _, _ in slots[len(single):]] == [C_BATCHED[r] for r in reads]
        n_single = n_single or len(single)
    for name, array in fields:
        if name == "ph":
            continue
        want = f"step_shift(P.{name}{'[a]' if array else ''}, S.{name}"
        assert want in case, name
    for name in ("A.u", "A.v", "A.p", "M.lv[l].st[a]", "M.lv[l].x", "M.lv[l].rhs"):
        assert f"step_shift(P.{name}, S.{name}" in case, name

    lib = _Recorder()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "kernel_device", lambda x: True)
    monkeypatch.setattr(_cuda, "stream_of", lambda x: 7)
    step._SCRATCH.clear()
    n, cases = 31, 3
    pres = interop.config(PRES)
    cfg = BODIES[algo][1]
    kw = _port_kw(n, cfg)
    kw["pres_cfg"] = pres
    n_in, n_out = step.ALGO_SCALARS[algo]
    u, v, p = (torch.zeros(cases, *s) for s in ((n + 1, n), (n, n + 1), (n, n)))
    last = torch.zeros(cases, n_out)
    active = torch.ones(cases, dtype=torch.bool)
    out1 = step._launch_batched(algo, u, v, p, last[:, :n_in], active, None, tuple(MUS), kw)
    held = (out1[3], out1[4], out1[5], out1[6], out1[7])
    out2 = step._launch_batched(algo, out1[0], out1[1], out1[2], out1[3][:, :n_in], active,
                                held, tuple(MUS), kw)
    (p1, ip1, fp1, s1), (p2, ip2, fp2, s2) = lib.calls
    slots = step.batched_launch_slots(algo, n, n, step.step_shapes(n, n, pres))
    half = len(slots)
    assert len(p1) == len(p2) == 2 * half and s1 == s2 == 7
    single_ip, single_fp = step.launch_params(algo, n, n, step.step_shapes(n, n, pres),
                                              mu=MUS[0], **kw)
    assert ip1 == ip2 == single_ip + [cases]
    assert fp1 == fp2 == [ctypes.c_float(x).value for x in single_fp]
    sizes = [int(np.prod(shape)) for _, shape, _ in slots]
    nbytes = [4 if dtype != torch.bool else 1 for _, _, dtype in slots]
    # scratch: the same addresses both calls, each slot's cases contiguous
    scratch = range(step.N_IO, half - 7)
    assert [p1[k] for k in scratch] == [p2[k] for k in scratch]
    assert all(p1[half + k] == p2[half + k] == 4 * sizes[k] for k in scratch)
    # the inputs by address with their own case strides
    assert p2[:3] == [out1[0].data_ptr(), out1[1].data_ptr(), out1[2].data_ptr()]
    assert p2[3] == out1[3].data_ptr() and p2[half + 3] == 4 * n_out
    assert p1[half:half + 3] == [4 * s for s in sizes[:3]]
    # the outputs: one buffer, output after output, each (cases, *shape)
    outs = range(4, step.N_IO)
    assert [p2[k + 1] - p2[k] for k in outs[:-1]] == [4 * cases * sizes[k] for k in outs[:-1]]
    assert all(p2[half + k] == 4 * sizes[k] for k in outs)
    assert p1[4] != p2[4]
    # held results, active flags and (De, Dn)
    assert p1[half - 7:half - 2] == [0] * 5 and p1[2 * half - 7:2 * half - 2] == [0] * 5
    want_held = [out1[3], out1[5], out1[6], out1[7], out1[4]]
    assert p2[half - 7:half - 2] == [x.data_ptr() for x in want_held]
    assert p2[2 * half - 7:2 * half - 2] == [nbytes[k] * sizes[k]
                                              for k in range(half - 7, half - 2)]
    assert p2[half - 2] == active.data_ptr() and p2[2 * half - 2] == 1
    assert p2[2 * half - 1] == 8
    _, _, _, visc = step._batch_params(algo, n, n, kw, tuple(MUS), u.device)
    assert p2[half - 1] == visc.data_ptr()
    for b, mu in enumerate(MUS):
        _, fpb = step.launch_params(algo, n, n, step.step_shapes(n, n, pres), mu=mu, **kw)
        assert visc[b].tolist() == [ctypes.c_float(fpb[2]).value, ctypes.c_float(fpb[3]).value]
    assert tuple(out2[0].shape) == (cases, n + 1, n) and out2[0].is_contiguous()
    assert tuple(out2[3].shape) == (cases, n_out) and out2[4].dtype == torch.int32
    with pytest.raises(ValueError, match="each case contiguous"):
        step._launch_batched(algo, u.transpose(1, 2).contiguous().transpose(1, 2), v, p,
                             last[:, :n_in], active, None, tuple(MUS), kw)
    with pytest.raises(ValueError, match="viscosities"):
        step.fused_outer_step_batched(algo, u, v, p, last[:, :n_in], active, mu=MUS[:2], **kw)
