"""K1 (the merged assembly + Chebyshev momentum pair) and K2a (strip_down)
of the PyTorch port, on the CPU: their C entries' pointer, integer and
float slots parsed from ``csrc/asmcheby.cuh`` and ``csrc/strip.cu`` against
the wrappers; K1's region, tile, shared memory and resident blocks at every
degree the gate admits, and K2a's staged region at every sweep count;
both wrappers' reuse of their host arrays and their one output allocation
(through a library that records its calls), with no ``torch.stack`` and no
``torch.max`` around K1's launch; the atomic-max rule of K1's Gershgorin
maxima; K1's phase-timer decoding; and the guard that CPU tensors run the
plain versions and agree with the JAX package's Pallas kernels in
interpret mode.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import naviflow_tpu as nf
from naviflow_tpu.core.bc import apply_velocity_bcs
from naviflow_tpu.ops.pallas_asmcheby import fused_asmcheby_pair as j_asmcheby
from naviflow_tpu.ops.pallas_strip import strip_down as j_down
from naviflow_tpu.ops.powerlaw import (relax_coefficients, u_momentum_coefficients,
                                       v_momentum_coefficients)
from naviflow_tpu.solvers.momentum import _bounds_from_rho, _u_interior_mask, _v_interior_mask
from naviflow_tpu.solvers.multigrid import MultigridConfig as JMultigridConfig

from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops import _cuda, asmcheby, strip
from naviflow_tpu_torch.ops.stencil9 import Stencil9
from naviflow_tpu_torch.solvers.multigrid import MultigridConfig

torch.set_num_threads(2)

CSRC = Path(asmcheby.__file__).resolve().parent.parent / "csrc"
# the H100's shared memory a block may use (232,448 bytes), and an SM's
# (233,472 bytes: 228 KB, of which the runtime reserves 1 KB a block)
BLOCK_SMEM = 227 * 1024
SM_SMEM = 228 * 1024
ALPHA = 0.7


def _src(name):
    return (CSRC / name).read_text()


def _constant(name, path):
    return int(re.search(rf"constexpr int {name} = (\d+);", _src(path)).group(1))


def _body(src, signature):
    """The text of the function whose definition starts with ``signature``."""
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


def _c_eval(expr, names):
    """A C integer expression of this file's constexpr helpers, in Python."""
    expr = re.sub(r"(\w+)\(", r"_f_\1(", expr).replace("/", "//")
    return eval(expr, {f"_f_{k}": v for k, v in names.items()} | names)  # noqa: S307


class _Recorder:
    """Records K1's and K2a's C entries' pointer, int and float arrays."""

    def __init__(self):
        self.calls = []

    def _record(self, name, ptrs, ip, fp, stream):
        self.calls.append((name, list(ptrs), list(ip), list(fp), stream, ptrs, ip, fp))
        return 0

    def nf_asmcheby_pair(self, *a):
        return self._record("nf_asmcheby_pair", *a)

    def nf_asmcheby_pair_phases(self, *a):
        return self._record("nf_asmcheby_pair_phases", *a)

    def nf_strip_down(self, *a):
        return self._record("nf_strip_down", *a)


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "require_all", lambda *a: None)
    monkeypatch.setattr(_cuda, "require", lambda *a: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda x: 7)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    # the launch state and counters of the fake launches stay in this test
    monkeypatch.setattr(asmcheby, "_LAUNCH", {})
    monkeypatch.setattr(strip, "_DOWN", {})
    monkeypatch.setattr(asmcheby, "LAUNCHES", asmcheby.LAUNCHES)
    monkeypatch.setattr(strip, "STRIP_DOWN_LAUNCHES", strip.STRIP_DOWN_LAUNCHES)
    return lib


class _Ops(TorchDispatchMode):
    """The PyTorch operators dispatched inside the mode."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket.__name__))
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# K1: the C entry and the launch shape


def _k1_entry():
    return _body(_src("asmcheby.cuh"), "int launch_asmcheby(")


def test_k1_slots_match_c_entry():
    """The wrapper's pointer slots against the C entry's reads: the inputs
    and the six interval scalars through ``ins[]``, the outputs through
    ``outs[]``, then the timed instantiation's timer buffer; the integer and
    float parameters in the wrapper's order."""
    entry = _k1_entry()
    ins = re.search(r"const float\*\* ins\[\] = \{([^}]*)\}", entry).group(1)
    outs = re.search(r"float\*\* outs\[\] = \{([^}]*)\}", entry).group(1)
    c_in = [f.strip().removeprefix("&P.") for f in ins.split(",")]
    c_out = [f.strip().removeprefix("&P.") for f in outs.split(",")]
    assert c_in + c_out == list(asmcheby.SLOTS)
    assert len(c_in) == asmcheby.N_IN
    assert f"for (int k = 0; k < {len(c_in)}; ++k) *ins[k]" in entry
    assert f"for (int k = 0; k < {len(c_out)}; ++k) *outs[k] = " \
           f"reinterpret_cast<float*>(ptrs[{len(c_in)} + k]);" in entry
    assert f"reinterpret_cast<unsigned long long*>(ptrs[{len(asmcheby.SLOTS)}])" in entry
    ip = re.findall(r"(\w+) = ip\[(\d)\]", entry)
    assert [name for name, _ in sorted(ip, key=lambda t: t[1])] == \
        ["nx", "ny", "degree", "variant"]
    fp = re.findall(r"P\.(\w+) = fp\[(\d)\]", entry)
    assert [name for name, _ in sorted(fp, key=lambda t: int(t[1]))] == \
        ["cFu", "cFv", "De", "Dn", "dx", "dy", "alpha", "one_m_alpha", "rho"]
    # the shared export and its timed twin
    assert "return launch_asmcheby<false>(ptrs, ip, fp, stream);" in _src("asmcheby.cu")
    assert "return launch_asmcheby<true>(ptrs, ip, fp, stream);" in _src("asmcheby_phases.cu")
    assert "cudaMemsetAsync(P.gmax, 0, 2 * sizeof(float), s)" in entry


@pytest.mark.parametrize("degree", range(1, asmcheby.PAD))
def test_k1_region_tile_and_shared_memory(degree):
    """csrc/asmcheby.cuh's region, tile and shared memory at every degree
    the gate admits, against the Python mirror: 64 x 64-face regions of 8
    faces a thread, a tile of >= 32 x 32 owned faces under the halo
    degree + 1; the shared memory within the H100's 227 KB a block; one
    block an SM, as the launch bounds ask, its registers (65,536 an SM)
    within 128 a thread."""
    src = _src("asmcheby.cuh")
    c = {k: _constant(k, "asmcheby.cuh") for k in ("THREADS", "CPL", "ROWS")}
    assert c["THREADS"] == asmcheby.THREADS
    for line in ("constexpr int WARPS = THREADS / 32;", "constexpr int RJ = 32 * CPL;",
                 "constexpr int PJ = RJ + 2;", "constexpr int RI = WARPS * ROWS;",
                 "constexpr int CELLS = ROWS * CPL;",
                 "__launch_bounds__(THREADS, 1) asmcheby_kernel"):
        assert line in src
    ri, rj = c["THREADS"] // 32 * c["ROWS"], 32 * c["CPL"]
    assert (ri, rj) == (asmcheby.RI, asmcheby.RJ) and c["ROWS"] * c["CPL"] == 8
    assert "return RI - 2 * (degree + 1);" in src and "return RJ - 2 * (degree + 1);" in src
    ti, tj = asmcheby.tile_shape(degree)
    assert (ti, tj) == (ri - 2 * (degree + 1), rj - 2 * (degree + 1))
    assert ti >= 32 and tj >= 32
    smem = re.search(r"constexpr int SMEM_FLOATS = (.*?);", src).group(1)
    assert smem == "2 * (RI + 2) * PJ + 8 * RI * RJ"
    nbytes = 4 * (2 * (ri + 2) * (rj + 2) + 8 * ri * rj)
    assert asmcheby.smem_bytes() == nbytes <= BLOCK_SMEM
    assert nbytes + 1024 <= SM_SMEM and 65536 // c["THREADS"] >= 128
    if degree == 4:  # the main path: 54 x 54 owned faces, 1.40x in the region
        assert (ti, tj) == (54, 54) and nbytes == 165920


def test_k1_phase_enum_and_decoding():
    """``decode_phases`` on synthetic stamps: per phase the summed ns, then
    the counts, then the last stamp (csrc/asmcheby.cuh K1Phase)."""
    body = re.search(r"enum K1Phase \{([^}]*)\}", _src("asmcheby.cuh")).group(1)
    enum = [e.split("=")[0].strip() for e in body.split(",")]
    assert [e.removeprefix("K1_").lower() for e in enum[:-1]] == list(asmcheby.PHASE_NAMES)
    assert enum[-1] == "NF_K1_PHASES"
    assert asmcheby.N_TIMERS == 2 * len(asmcheby.PHASE_NAMES) + 1
    got = asmcheby.decode_phases([2_000_000, 500_000, 250_000, 125_000, 8, 16, 8, 4, 99])
    assert got == {"assembly": (2.0, 8), "chebyshev": (0.5, 16), "residual": (0.25, 8),
                   "pressure": (0.125, 4)}
    with pytest.raises(ValueError):
        asmcheby.decode_phases([0] * 8)


# ---------------------------------------------------------------------------
# K1: the wrapper


def _k1_inputs(nx, ny):
    rng = np.random.default_rng(3)
    u, v, p = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
               for s in ((nx + 1, ny), (nx, ny + 1), (nx, ny)))
    bounds = [torch.tensor(x, dtype=torch.float32) for x in (1.0, 0.5, 2.0, 1.1, 0.4, 2.75)]
    return u, v, p, bounds


def test_k1_wrapper_reuses_host_arrays_and_allocates_once(recorder):
    """Through a recording library, two calls at one shape: the same
    pointer, integer and float arrays; inputs, the six 0-d interval
    scalars by address and every output at its slot of ONE fresh buffer,
    each output 256-byte aligned; rho_u / rho_v 0-d views of the gmax pair.
    The only PyTorch operators the calls dispatch are the buffer's
    allocation and the outputs' views: no torch.stack, no torch.max."""
    nx, ny = 48, 40
    u, v, p, bnd = _k1_inputs(nx, ny)
    kw = dict(dx=0.5, dy=0.25, rho=1.0, mu=0.01, alpha=ALPHA, degree=4,
              bounds_u=tuple(bnd[:3]), bounds_v=tuple(bnd[3:]))
    launches = asmcheby.LAUNCHES
    with _Ops() as ops:
        out1 = asmcheby.fused_asmcheby_pair(u, v, p, **kw)
        out2 = asmcheby.fused_asmcheby_pair(u, v, p, **kw)
    assert set(ops.names) <= {"empty", "as_strided"}, ops.names
    assert ops.names.count("empty") == 2
    (e1, p1, ip1, fp1, s1, a1, i1, f1), (_, p2, _, _, _, a2, i2, f2) = recorder.calls
    assert e1 == "nf_asmcheby_pair" and s1 == 7 and asmcheby.LAUNCHES == launches + 2
    assert a1 is a2 and i1 is i2 and f1 is f2  # the same host arrays
    assert ip1 == [nx, ny, 4, 0]
    assert fp1 == pytest.approx([0.5 * 0.25, 0.5 * 0.5, 0.01 * 0.25 / 0.5, 0.01 * 0.5 / 0.25,
                                 0.5, 0.25, ALPHA, 1 - ALPHA, 1.0])
    n_in = asmcheby.N_IN
    assert p1[:n_in] == [u.data_ptr(), v.data_ptr(), p.data_ptr(), *[b.data_ptr() for b in bnd]]
    layout, total = asmcheby.output_layout(nx, ny)
    for out, ptrs in ((out1, p1), (out2, p2)):
        u_star, r_u, v_star, r_v, d_u, d_v, pc, rho_u, rho_v = out
        views = [u_star, r_u, v_star, r_v, d_u, d_v, pc.a_e, pc.a_w, pc.a_n, pc.a_s, pc.diag]
        base = u_star.untyped_storage().data_ptr()
        assert all(t.untyped_storage().data_ptr() == base for t in (*views, rho_u, rho_v))
        assert u_star.untyped_storage().nbytes() == 4 * total
        want_shapes = [(nx + 1, ny)] * 2 + [(nx, ny + 1)] * 2 + [(nx + 1, ny), (nx, ny + 1)] \
            + [(nx, ny)] * 5
        assert [tuple(t.shape) for t in views] == want_shapes
        assert all(t.is_contiguous() for t in views)
        assert ptrs[n_in:len(asmcheby.SLOTS)] == [t.data_ptr() for t in views] + \
            [rho_u.data_ptr()]
        assert all((t.data_ptr() - base) % 256 == 0 for t in views)
        assert rho_u.dim() == rho_v.dim() == 0 and rho_v.data_ptr() == rho_u.data_ptr() + 4
        assert rho_u.data_ptr() - base == 4 * layout[-1][0]
    assert p1[n_in:] != p2[n_in:]  # a fresh buffer a call


def test_k1_wrapper_copies_numbers_once_and_raises(recorder):
    """Python numbers as interval scalars go to the device in one tensor
    (six consecutive addresses); a degree beyond the halo or an unknown
    operator raises before any launch; the timed instantiation appends the
    timer buffer through the same arrays."""
    u, v, p, _ = _k1_inputs(16, 24)
    kw = dict(dx=0.1, dy=0.1, rho=1.0, mu=0.01, alpha=ALPHA, degree=2)
    asmcheby.fused_asmcheby_pair(u, v, p, bounds_u=(1.0, 0.5, 2.0), bounds_v=(1.0, 0.5, 2.0),
                                 **kw)
    scal = recorder.calls[0][1][3:9]
    assert [b - a for a, b in zip(scal, scal[1:])] == [4] * 5
    with pytest.raises(ValueError, match="degree"):
        asmcheby.fused_asmcheby_pair(u, v, p, bounds_u=(1.0,) * 3, bounds_v=(1.0,) * 3,
                                     **dict(kw, degree=asmcheby.PAD))
    with pytest.raises(ValueError, match="variant"):
        asmcheby.fused_asmcheby_pair(u, v, p, bounds_u=(1.0,) * 3, bounds_v=(1.0,) * 3,
                                     poisson_variant="nope", **kw)
    assert len(recorder.calls) == 1
    launches = asmcheby.LAUNCHES
    _, phases = asmcheby.fused_asmcheby_pair_phases(u, v, p, bounds_u=(1.0,) * 3,
                                                    bounds_v=(1.0,) * 3, **kw)
    assert asmcheby.LAUNCHES == launches  # the timed launch is not counted
    assert phases == {name: (0.0, 0) for name in asmcheby.PHASE_NAMES}
    name, ptrs, *_ = recorder.calls[1]
    assert name == "nf_asmcheby_pair_phases" and len(ptrs) == len(asmcheby.SLOTS) + 1
    assert recorder.calls[1][5] is recorder.calls[0][5]


@pytest.mark.parametrize("ratios", [
    [0.0, 0.25, 3.5, 1e-30],           # non-negative
    [0.0, 0.0, 0.0],                   # zeros only
    [-2.0, 0.5, -1e30, 0.125],         # negative a_p's ratios lose to 0
    [-0.0, -0.0, -3.0],                # -0.0 and negatives: +0.0 wins
    [-0.0, 7.0, 2.5, -0.0],
])
def test_gershgorin_atomic_max_bit_rule(ratios):
    """K1's per-block maxima combine by a signed-int atomicMax on the
    float's bits, from +0.0: the result equals the plain version's
    torch.max over torch.where(mask, ratio, 0) (the mask leaves at least
    one 0) in every order of the blocks."""
    vals = np.array(ratios, dtype=np.float32)
    want = torch.max(torch.where(torch.tensor([True] * len(vals) + [False]),
                                 torch.tensor(np.append(vals, np.float32(5.0))),
                                 torch.zeros(len(vals) + 1)))
    rng = np.random.default_rng(0)
    for _ in range(4):
        acc = np.int32(0)  # the bits of +0.0
        for bits in rng.permutation(vals).view(np.int32):
            acc = max(acc, bits)
        got = np.array([acc], dtype=np.int32).view(np.float32)[0]
        assert got == float(want) and np.signbit(got) == bool(torch.signbit(want))


# ---------------------------------------------------------------------------
# K2a: the C entry and the staged region


def _strip_entry():
    return _body(_src("strip.cu"), "int launch_down(")


def test_k2a_slots_match_c_entry():
    """strip_down's pointer slots against the C entry: p, b and the 5 or 9
    stencil arrays into ``P.a[]``, then the two outputs; the integer
    parameters nx, ny, five, sweeps and omega as the one float."""
    entry = _strip_entry()
    assert "for (int a = 0; a < ns + 2; ++a) {" in entry
    assert "P.a[a] = reinterpret_cast<const float*>(ptrs[a]);" in entry
    assert "P.out_p = reinterpret_cast<float*>(ptrs[ns + 2]);" in entry
    assert "P.out_rc = reinterpret_cast<float*>(ptrs[ns + 3]);" in entry
    assert "const int nx = ip[0], ny = ip[1], five = ip[2], sweeps = ip[3];" in entry
    assert "P.omega = fp[0];" in entry
    order = re.search(r"const float\* a\[11\];\s*// (.*)", _src("strip.cu")).group(1)
    names = [w.strip().split()[-1] for w in order.split("(")[0].split(",")]
    assert names == ["p", "b", "c", "e", "w", "n", "s", "ne", "nw", "se", "sw"]
    for five in (True, False):
        slots = strip.down_slots(five)
        ns = 5 if five else 9
        assert list(slots[:ns + 2]) == names[:ns + 2]
        assert slots[ns + 2:] == ("p_out", "rc")


@pytest.mark.parametrize("five", [True, False], ids=["five", "nine"])
@pytest.mark.parametrize("sweeps", [0, 1, 2])
def test_k2a_staged_region_and_shared_memory(five, sweeps):
    """strip.cu's staged region (the constexpr helpers, evaluated from the
    source) against the Python mirror: an owned tile of 32 x 64 cells, halo
    colours x sweeps + 1, the columns' margin rounded up to a multiple of 4
    (16-byte rows), all 7 or 11 arrays within the H100's 227 KB a block;
    the 1-sweep levels of the main path take 76,608 (5-point, 512 threads:
    three blocks an SM) and 147,840 bytes (9-point, 1024 threads: one)."""
    src = _src("strip.cu")
    tile = _constant("TILE", "strip.cu")
    tj = _constant("DOWN_TJ", "strip.cu")
    assert (tile, tj) == (strip.TILE, strip.DOWN_TILE_J)
    threads = re.search(r"down_threads\(int ns\) \{ return ns == 5 \? (\d+) : (\d+);", src)
    assert (strip.down_threads(True), strip.down_threads(False)) == \
        (int(threads.group(1)), int(threads.group(2)))
    assert "__launch_bounds__(down_threads(NS)) strip_down_kernel" in src
    helpers = dict(re.findall(
        r"constexpr int (down_\w+)\(int ns(?:, int sweeps)?\) \{\s*return (.*?);\s*\}", src,
        re.S))
    assert set(helpers) == {"down_threads", "down_colors", "down_halo", "down_margin",
                            "down_rows", "down_cols", "down_smem_floats"}
    funcs = {}
    for name in ("down_colors", "down_halo", "down_margin", "down_rows", "down_cols",
                 "down_smem_floats"):
        expr = " ".join(helpers[name].split()).replace("ns == 5 ? 2 : 4", "(2 if ns == 5 else 4)")
        funcs[name] = (lambda e: lambda ns, sweeps=None: _c_eval(
            e, {**funcs, "ns": ns, "sweeps": sweeps, "TILE": tile, "DOWN_TJ": tj}))(expr)
    ns = 5 if five else 9
    rows, cols, h, m = strip.down_region(five, sweeps)
    assert (h, m) == (funcs["down_halo"](ns, sweeps), funcs["down_margin"](ns, sweeps))
    assert (rows, cols) == (funcs["down_rows"](ns, sweeps), funcs["down_cols"](ns, sweeps))
    assert h == (2 if five else 4) * sweeps + 1 and m % 4 == 0 and m - h < 4
    nbytes = 4 * funcs["down_smem_floats"](ns, sweeps)
    assert strip.down_smem_bytes(five, sweeps) == nbytes <= BLOCK_SMEM
    # the region is staged by the copy code K2 shares with K11a (common.cuh)
    assert "nf_stage_region<R, 0, R::A>(P, (unsigned)__cvta_generic_to_shared(s), i0, j0);" in src
    common = _src("common.cuh")
    assert "cp.async.cg.shared.global [%0], [%1], 16, %2;" in common
    assert "nf_cp16(dst + 4u * a * R::PLANE, P.a[a] + g, in);" in _body(
        common, "__device__ __forceinline__ void nf_stage_region(")
    if sweeps == 1:
        assert nbytes == (76608 if five else 147840)
        blocks = 3 if five else 1
        assert (nbytes + 1024) * blocks <= SM_SMEM < (nbytes + 1024) * (blocks + 1)
        assert blocks * strip.down_threads(five) <= 2048


@pytest.mark.parametrize("five", [True, False], ids=["five", "nine"])
@pytest.mark.parametrize("sweeps", [0, 1, 2])
def test_k2a_stages_every_cell_it_reads(five, sweeps):
    """strip_down stages b and the stencil on the region less its outer ring
    (rows 1..RI-2, columns QLO..QHI-1 from strip.cu): every cell a colour
    pass updates, and every owned cell of the residual, lies inside, and
    each pass updates its own colour's cells of the shrinking region."""
    src = _src("strip.cu")
    rows, cols, h, m = strip.down_region(five, sweeps)
    tj = strip.DOWN_TILE_J
    qlo_expr, qhi_expr = re.search(
        r"constexpr int QLO = (.*?), QHI = (.*?);", src).groups()
    env = {"M": m, "H": h, "TJ": tj}
    qlo, qhi = (eval(e.replace("/", "//"), {}, env) for e in (qlo_expr, qhi_expr))  # noqa: S307
    assert qlo % 4 == 0 and qhi % 4 == 0 and 0 <= qlo and qhi <= cols
    colors = 2 if five else 4
    for n in range(1, colors * sweeps + 1):
        c = (n - 1) % colors
        for r in range(n, rows - n):
            for q in range(m - h + n, m + tj + h - n):
                gi, gj = r + h, q  # parities of the global cell (tiles start even)
                color = (gi + gj) % 2 if five else 2 * (gi % 2) + gj % 2
                if color == c:
                    assert 1 <= r < rows - 1 and qlo <= q < qhi
    for r in range(h, h + strip.TILE):
        assert 1 <= r < rows - 1 and qlo <= m and m + tj <= qhi


def _stencil(n, five, seed=5):
    rng = np.random.default_rng(seed)
    arrays = {k: torch.as_tensor(rng.normal(size=(n, n)), dtype=torch.float32)
              for k in ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")}
    if five:
        for k in ("ne", "nw", "se", "sw"):
            arrays[k] = torch.zeros(n, n)
    return Stencil9(**arrays)


@pytest.mark.parametrize("five", [True, False], ids=["five", "nine"])
def test_k2a_wrapper_reuses_host_arrays_and_allocates_once(recorder, five):
    """Through a recording library: one pointer array per (shape, five,
    sweeps), the slots in down_slots' order; both outputs views of one
    fresh buffer a call, the coarse residual right after the smoothed
    field; a new shape gets its own arrays."""
    n = 64
    st = _stencil(n, five)
    p, b = torch.zeros(n, n), torch.ones(n, n)
    cfg = MultigridConfig(pre_smoothing=1, post_smoothing=1, omega=1.2)
    x1, rc1 = strip.strip_down(p, b, st, cfg, five)
    x2, rc2 = strip.strip_down(p, b, st, cfg, five)
    strip.strip_down(torch.zeros(32, 32), torch.zeros(32, 32), _stencil(32, five), cfg, five)
    (e1, p1, ip1, fp1, s1, a1, i1, f1), (_, p2, ip2, _, _, a2, i2, _), (_, _, ip3, _, _, a3,
                                                                         _, _) = recorder.calls
    assert e1 == "nf_strip_down" and s1 == 7 and fp1 == pytest.approx([1.2])
    assert a1 is a2 and i1 is i2 and a3 is not a1
    assert ip1 == ip2 == [n, n, int(five), 1] and ip3 == [32, 32, int(five), 1]
    names = strip.down_slots(five)
    assert len(p1) == len(names)
    arrays = [getattr(st, k) for k in names[2:-2]]
    assert p1[:-2] == [p.data_ptr(), b.data_ptr(), *[a.data_ptr() for a in arrays]]
    for (x, rc), ptrs in (((x1, rc1), p1), ((x2, rc2), p2)):
        assert x.untyped_storage().data_ptr() == rc.untyped_storage().data_ptr()
        assert tuple(x.shape) == (n, n) and tuple(rc.shape) == (n // 2, n // 2)
        assert ptrs[-2:] == [x.data_ptr(), rc.data_ptr()]
        assert rc.data_ptr() - x.data_ptr() == 4 * n * n
    assert p1[-2:] != p2[-2:]


# ---------------------------------------------------------------------------
# the CPU path against the Pallas kernels


def T(x):
    return interop.tensor(x, dtype=torch.float32)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-30)


def _cavity_fields(n, seed=11):
    rng = np.random.default_rng(seed)
    mesh = nf.StructuredMesh(nx=n, ny=n)
    bc = nf.lid_driven_cavity(1.0)
    st = nf.initialize_state(mesh, bc, dtype=jnp.float32)
    u = jnp.asarray(st.u + 0.1 * rng.normal(size=st.u.shape), jnp.float32)
    v = jnp.asarray(st.v + 0.1 * rng.normal(size=st.v.shape), jnp.float32)
    p = jnp.asarray(rng.normal(size=st.p.shape), jnp.float32)
    u, v = apply_velocity_bcs(u, v, bc)
    return u, v, p, dict(dx=1.0 / (n - 1), dy=1.0 / (n - 1), rho=1.0, mu=0.01)


@pytest.mark.parametrize("degree", [4, 6])
@pytest.mark.parametrize("variant", ["consistent", "symmetric"])
def test_k1_cpu_runs_plain_and_matches_pallas(degree, variant):
    """CPU tensors run K1's plain version (no launch) and agree with the
    Pallas kernel in interpret mode at 64^2, at tests/test_pallas_asmcheby.py's
    tolerances (2e-5 on fields and operators, 5e-5 on residuals, 1e-6 on
    the maxima), the interval scalars given as 0-d tensors."""
    u, v, p, kw = _cavity_fields(64)

    def raw_rho(c_un, c_rel, mask):
        safe = jnp.where(c_rel.a_p == 0, 1.0, c_rel.a_p)
        nb = jnp.abs(c_un.a_e) + jnp.abs(c_un.a_w) + jnp.abs(c_un.a_n) + jnp.abs(c_un.a_s)
        return jnp.max(jnp.where(mask, nb / safe, 0.0))

    cu = u_momentum_coefficients(u, v, p, **kw)
    cv = v_momentum_coefficients(u, v, p, **kw)
    bu = _bounds_from_rho(raw_rho(cu, relax_coefficients(cu, u, ALPHA),
                                  _u_interior_mask(u.shape)), 1.05)
    bv = _bounds_from_rho(raw_rho(cv, relax_coefficients(cv, v, ALPHA),
                                  _v_interior_mask(v.shape)), 1.05)
    want = j_asmcheby(u, v, p, alpha=ALPHA, degree=degree, bounds_u=bu, bounds_v=bv,
                      poisson_variant=variant, interpret=True, **kw)
    launches = asmcheby.LAUNCHES
    got = asmcheby.fused_asmcheby_pair(
        T(u), T(v), T(p), alpha=ALPHA, degree=degree, bounds_u=tuple(T(s) for s in bu),
        bounds_v=tuple(T(s) for s in bv), poisson_variant=variant, **kw)
    assert asmcheby.LAUNCHES == launches
    for k, tol in enumerate([2e-5, 5e-5, 2e-5, 5e-5, 2e-5, 2e-5]):
        assert rel_err(got[k], want[k]) < tol, k
    for name in ("a_e", "a_w", "a_n", "a_s", "diag"):
        assert rel_err(getattr(got[6], name), getattr(want[6], name)) < 2e-5, name
    assert rel_err(got[7], want[7]) < 1e-6 and rel_err(got[8], want[8]) < 1e-6


def _strip_problem(five, n=64):
    from naviflow_tpu_torch.ops.poisson import poisson_coefficients
    from naviflow_tpu_torch.ops.stencil9 import from_poisson, galerkin_coarsen
    from naviflow_tpu_torch.ops.transfer_cc import prolong_cc, restrict_cc

    rng = np.random.default_rng(4 if five else 13)
    nf_ = n if five else 2 * n
    d_u = torch.as_tensor(rng.uniform(0.5, 1.5, (nf_ + 1, nf_)), dtype=torch.float32)
    d_v = torch.as_tensor(rng.uniform(0.5, 1.5, (nf_, nf_ + 1)), dtype=torch.float32)
    st = from_poisson(poisson_coefficients(d_u, d_v, dx=1.0 / nf_, dy=1.0 / nf_, rho=1.0,
                                           variant="consistent"))
    if not five:
        st = galerkin_coarsen(st, restrict_cc, prolong_cc, n, n)
    p = rng.normal(size=(n, n)).astype(np.float32)
    b = rng.normal(size=(n, n)).astype(np.float32)
    return st, p, b


@pytest.mark.parametrize("five", [True, False], ids=["five", "nine"])
@pytest.mark.parametrize("sweeps", [1, 2])
def test_k2a_cpu_runs_plain_and_matches_pallas(five, sweeps):
    """CPU tensors run strip_down's plain version (no launch) and agree with
    the Pallas kernel in interpret mode on a 64^2 level (5-point from a
    random consistent operator, 9-point its Galerkin coarsening of 128^2),
    at tests/test_pallas_strip.py's rtol 1e-5 / atol 1e-4."""
    from naviflow_tpu.ops.stencil9 import Stencil9 as JStencil9

    st, p, b = _strip_problem(five)
    jst = JStencil9(**{k: jnp.asarray(getattr(st, k).numpy()) for k in
                       ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")})
    jcfg = JMultigridConfig(pre_smoothing=sweeps, post_smoothing=sweeps)
    tcfg = MultigridConfig(pre_smoothing=sweeps, post_smoothing=sweeps)
    want_x, want_rc = j_down(jnp.asarray(p), jnp.asarray(b), jst, jcfg, five=five,
                             interpret=True)
    launches = strip.STRIP_DOWN_LAUNCHES
    got_x, got_rc = strip.strip_down(torch.as_tensor(p), torch.as_tensor(b), st, tcfg, five)
    assert strip.STRIP_DOWN_LAUNCHES == launches
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_rc.numpy(), np.asarray(want_rc), rtol=1e-5, atol=1e-4)
