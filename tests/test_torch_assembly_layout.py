"""K8's single wrapper on the CPU (``ops/assembly.fused_assembly_pair``):
the one output buffer's layout for each form, the C entry's slots parsed
from ``csrc/assembly.cu``, and the host arrays the wrapper keeps per
(device, stream, shape, variant, bounds, physics), through a library that
records its calls.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from naviflow_tpu_torch.ops import _cuda, assembly

torch.set_num_threads(2)

CSRC = Path(assembly.__file__).resolve().parent.parent / "csrc"
FORMS = [(False, None), (True, None), (False, "consistent"), (True, "consistent"),
         (False, "symmetric"), (True, "symmetric"), (False, "reference"),
         (True, "reference")]
SHAPES = [(48, 40), (63, 47), (1024, 1024), (2048, 2048)]


def _body(signature):
    src = (CSRC / "assembly.cu").read_text()
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


def _want_shapes(nx, ny, fold):
    """The C entry's outputs in slot order (``read_assembly``)."""
    u, v, c = (nx + 1, ny), (nx, ny + 1), (nx, ny)
    return [u] * 8 + [v] * 8 + [(2,)] + ([u, v] + [c] * 5 if fold else [])


@pytest.mark.parametrize("fold", [False, True], ids=["plain", "fold"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}x{b}" for a, b in SHAPES])
def test_layout_is_aligned_disjoint_and_covers_every_output(shape, fold):
    """Each output's offset is on a 256-byte boundary, the outputs do not
    overlap, each has its slot's shape, and the buffer holds them all; the
    groups the views are cut from give the same offsets."""
    nx, ny = shape
    layout, total = assembly.output_layout(nx, ny, fold)
    assert [s for _, s in layout] == _want_shapes(nx, ny, fold)
    spans = sorted((off, off + int(np.prod(s))) for off, s in layout)
    assert all(off % 64 == 0 for off, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= total and total % 64 == 0
    groups, total_g = assembly.output_groups(nx, ny, fold)
    assert total_g == total
    starts = {off + k * pitch for off, count, _, pitch in groups for k in range(count)}
    assert starts == {off for off, _ in layout}


def test_c_entry_reads_the_wrappers_slots():
    """``read_assembly`` reads u, v, p, the eight u and eight v coefficient
    arrays, the maxima pair, then with the fold d_u, d_v and the operator's
    five; the single entry passes the bounds flag from ip[3]."""
    reader = _body("int read_assembly(")
    order = re.findall(r"(P\.\w+(?:\[a\])?) = next\(\)", reader)
    assert order == ["P.u", "P.v", "P.p", "P.cu[a]", "P.cv[a]", "P.gmax", "P.d_u", "P.d_v",
                     "P.pc[a]"]
    assert "P.nx = ip[0]; P.ny = ip[1]; P.variant = ip[2];" in reader
    single = _body("NF_EXPORT int nf_fused_assembly_pair(")
    assert "launch<false>(P, AsmCases{}, ip[3] != 0, (cudaStream_t)stream);" in single
    launch = _body("int launch_one(")
    assert "cudaMemsetAsync(P.gmax, 0, 2 * sizeof(float), s)" in launch


class _Recorder:
    def __init__(self):
        self.calls = []

    def nf_fused_assembly_pair(self, ptrs, ip, fp, stream):
        self.calls.append((list(ptrs), list(ip), list(fp), stream, ptrs, ip, fp))
        return 0


class _Ops(TorchDispatchMode):
    """The PyTorch operators dispatched inside the mode."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket.__name__))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_of", lambda x: 7)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(assembly, "_LAUNCH", {})
    monkeypatch.setattr(assembly, "LAUNCHES", 0)
    return lib


def _inputs(nx, ny):
    rng = np.random.default_rng(5)
    return [torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
            for s in ((nx + 1, ny), (nx, ny + 1), (nx, ny))]


@pytest.mark.parametrize("bounds,variant", FORMS)
def test_wrapper_outputs_are_views_of_one_buffer(recorder, bounds, variant):
    """Every output of each form at its slot of one fresh buffer a call, in
    the shape the caller gets; the maxima 0-d views of the kernel's pair;
    ip carries the variant and the bounds flag; the only operators a call
    dispatches are the buffer's allocation and the views."""
    nx, ny = 48, 40
    u, v, p = _inputs(nx, ny)
    with _Ops() as ops:
        out = assembly.fused_assembly_pair(u, v, p, dx=0.5, dy=0.25, rho=1.0, mu=0.01,
                                           alpha=0.7, with_bounds=bounds,
                                           poisson_variant=variant)
    assert set(ops.names) <= {"empty", "as_strided", "unbind", "select"}, ops.names
    assert ops.names.count("empty") == 1
    (ptrs, ip, fp, stream, *_), = recorder.calls
    fold = variant is not None
    assert stream == 7 and assembly.LAUNCHES == 1
    assert ip == [nx, ny, assembly._VARIANTS.get(variant, -1), int(bounds)]
    assert fp == pytest.approx([0.125, 0.25, 0.01 * 0.25 / 0.5, 0.01 * 0.5 / 0.25, 0.5, 0.25,
                                0.7, 0.3, 1.0])
    assert ptrs[:3] == [u.data_ptr(), v.data_ptr(), p.data_ptr()]
    flat = assembly._flat(out, bounds, variant)
    layout, total = assembly.output_layout(nx, ny, fold)
    base = flat[0].untyped_storage().data_ptr()
    assert flat[0].untyped_storage().nbytes() == 4 * total
    assert ptrs[3:] == [base + 4 * off for off, _ in layout]
    coef = flat[:16] + (flat[-7:] if fold else ())
    slots = list(range(16)) + (list(range(17, 24)) if fold else [])
    for t, k in zip(coef, slots):
        assert t.data_ptr() == ptrs[3 + k] and tuple(t.shape) == layout[k][1]
        assert t.is_contiguous()
    if bounds:
        rho_u, rho_v = flat[16:18]
        assert rho_u.dim() == rho_v.dim() == 0
        assert rho_u.data_ptr() == ptrs[3 + 16] and rho_v.data_ptr() == rho_u.data_ptr() + 4
    assert len(flat) == 16 + 2 * bounds + 7 * fold


def test_wrapper_keeps_host_arrays_per_physics(recorder):
    """Two calls alike share one set of host arrays and fill new output
    pointers; a call with another ``mu``, ``alpha``, variant or bounds flag
    gets arrays of its own, with its own floats and integers."""
    u, v, p = _inputs(32, 24)
    kw = dict(dx=0.1, dy=0.2, rho=1.0, mu=0.01, alpha=0.7, with_bounds=True,
              poisson_variant="consistent")
    call = assembly.fused_assembly_pair
    kept = call(u, v, p, **kw), call(u, v, p, **kw)  # both buffers alive
    call(u, v, p, **dict(kw, mu=0.02))
    call(u, v, p, **dict(kw, alpha=0.5))
    call(u, v, p, **dict(kw, poisson_variant="reference"))
    call(u, v, p, **dict(kw, with_bounds=False))
    c = recorder.calls
    assert c[0][4] is c[1][4] and c[0][5] is c[1][5] and c[0][6] is c[1][6]
    assert c[0][0][3:] != c[1][0][3:] and len(kept) == 2  # a fresh buffer a call
    assert len(assembly._LAUNCH) == 5
    arrays = [call_[4] for call_ in c[1:]]
    assert len({id(a) for a in arrays}) == 5
    assert c[2][2][2:4] == pytest.approx([0.02 * 0.2 / 0.1, 0.02 * 0.1 / 0.2])
    assert c[0][2][2:4] == pytest.approx([0.01 * 0.2 / 0.1, 0.01 * 0.1 / 0.2])
    assert c[3][2][6:8] == pytest.approx([0.5, 0.5]) and c[0][2][6:8] == pytest.approx([0.7, 0.3])
    assert c[4][1][2] == 2 and c[0][1][2] == 0
    assert c[5][1][3] == 0 and c[0][1][3] == 1
    with pytest.raises(ValueError, match="variant"):
        call(u, v, p, **dict(kw, poisson_variant="nope"))
    assert len(recorder.calls) == 6
