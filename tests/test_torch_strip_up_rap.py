"""K2b (strip_up) and K4 (galerkin_levels) of the PyTorch port, on the CPU.

K2b: its C entry's pointer slots parsed from ``csrc/strip.cu`` against the
wrapper; its staged region, coarse box and shared memory at every (points,
sweeps) instance against the source's constexpr helpers; a model of its
passes and its prolongation showing that every cell they read was staged
(the coarse box with its clamp at the grid's edges included); the
wrapper's reuse of its host arrays and its one output allocation (through
a library that records its calls).  K4: its C entry's slots and the
wrapper's one-buffer layout (every view on a 256-byte boundary), the
wrapper's reuse of its host arrays per hierarchy, and a float32 numpy
model of ``csrc/cluster.cuh``'s ``nf_cl_rap_pass`` (the weights of
``nf_cl_axis_weights``, its loop order) against the plain chain and the
JAX package's Pallas kernel in interpret mode.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naviflow_tpu.ops.pallas_mg import galerkin_levels_pallas as j_rap
from naviflow_tpu.ops.stencil9 import Stencil9 as JStencil9

from naviflow_tpu_torch.ops import _cuda, mg, strip
from naviflow_tpu_torch.ops.stencil9 import Stencil9
from naviflow_tpu_torch.solvers.multigrid import MultigridConfig, build_levels

torch.set_num_threads(2)

CSRC = Path(strip.__file__).resolve().parent.parent / "csrc"
# the H100's shared memory a block may use (232,448 bytes), and an SM's
# (233,472 bytes: 228 KB, of which the runtime reserves 1 KB a block)
BLOCK_SMEM = 227 * 1024
SM_SMEM = 228 * 1024
NAMES = ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")


def _src(name):
    return (CSRC / name).read_text()


def _constant(name, path):
    return int(re.search(rf"constexpr int {name} = (\d+);", _src(path)).group(1))


def _body(src, signature):
    """The text of the function whose definition starts with ``signature``."""
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


class _Recorder:
    """Records K2b's and K4's C entries' pointer, int and float arrays."""

    def __init__(self):
        self.calls = []

    def _record(self, name, ptrs, ip, fp, stream):
        self.calls.append((name, list(ptrs), list(ip), list(fp), stream, ptrs, ip, fp))
        return 0

    def nf_strip_up(self, *a):
        return self._record("nf_strip_up", *a)

    def nf_galerkin_levels(self, *a):
        return self._record("nf_galerkin_levels", *a)


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "require_all", lambda *a: None)
    monkeypatch.setattr(_cuda, "require", lambda *a: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda x: 7)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    # the launch state and counters of the fake launches stay in this test
    monkeypatch.setattr(strip, "_UP", {})
    monkeypatch.setattr(mg, "_RAP", {})
    monkeypatch.setattr(strip, "STRIP_UP_LAUNCHES", strip.STRIP_UP_LAUNCHES)
    monkeypatch.setattr(mg, "RAP_LAUNCHES", mg.RAP_LAUNCHES)
    return lib


# ---------------------------------------------------------------------------
# K2b: the C entry, the staged region and the box


def test_k2b_slots_match_c_entry():
    """strip_up's pointer slots against nf_strip_up's documented slots and
    its launcher: p, b and the 5 or 9 stencil arrays into ``P.a[]``, then
    the coarse correction and the output; nx, ny, five, sweeps; omega."""
    src = _src("strip.cu")
    doc = re.search(r"// ptrs: (.*?);\s*ip: (.*?);\s*fp: (.*)\nNF_EXPORT int nf_strip_up\(",
                    src)
    assert doc.group(1) == "p, b, stencil (5 or 9), ec, out_p"
    assert doc.group(2) == "nx, ny, five, sweeps (0..2)" and doc.group(3) == "omega"
    entry = _body(src, "int launch_up(")
    assert "for (int a = 0; a < ns + 2; ++a) {" in entry
    assert "P.a[a] = reinterpret_cast<const float*>(ptrs[a]);" in entry
    assert "P.ec = reinterpret_cast<const float*>(ptrs[ns + 2]);" in entry
    assert "P.out_p = reinterpret_cast<float*>(ptrs[ns + 3]);" in entry
    assert "const int nx = ip[0], ny = ip[1], five = ip[2], sweeps = ip[3];" in entry
    assert "P.omega = fp[0];" in entry
    for five in (True, False):
        ns = 5 if five else 9
        slots = strip.up_slots(five)
        assert slots[:2] == ("p", "b") and slots[2:ns + 2] == NAMES[:ns]
        assert slots[ns + 2:] == ("ec", "p_out")


def _up_helpers():
    """strip.cu's up_* constexpr helpers as Python functions of (ns, sweeps)."""
    src = _src("strip.cu")
    helpers = dict(re.findall(
        r"constexpr int (up_\w+)\(int ns, int sweeps\) \{\s*return (.*?);\s*\}", src, re.S))
    assert set(helpers) == {"up_halo", "up_margin", "up_rows", "up_cols", "up_box_rows",
                            "up_box_col0", "up_box_cols", "up_arrays", "up_smem_floats"}
    consts = {"TILE": _constant("TILE", "strip.cu"), "DOWN_TJ": _constant("DOWN_TJ", "strip.cu")}
    funcs = {"down_colors": lambda ns: 2 if ns == 5 else 4}
    for name, expr in helpers.items():
        expr = " ".join(expr.split()).replace("sweeps ? ns + 2 : 1", "(ns + 2 if sweeps else 1)")
        py = re.sub(r"(\w+)\(", r"_f_\1(", expr).replace("/", "//")

        def f(ns, sweeps, py=py):
            env = {f"_f_{k}": v for k, v in funcs.items()}
            return eval(py, env, {**consts, "ns": ns, "sweeps": sweeps})  # noqa: S307

        funcs[name] = f
    return funcs


@pytest.mark.parametrize("five", [True, False], ids=["five", "nine"])
@pytest.mark.parametrize("sweeps", [0, 1, 2])
def test_k2b_staged_region_and_shared_memory(five, sweeps):
    """strip.cu's up_* helpers (evaluated from the source) against the
    Python mirror: halo colours x sweeps (no residual ring), the column
    margin rounded up to 4, the coarse box from a multiple of 4; every
    instance within the H100's 227 KB a block; the 1-sweep levels of the
    main path take 75,776 bytes (5-point, 512 threads: three blocks an SM)
    and 130,240 (9-point, 1024 threads: one)."""
    f = _up_helpers()
    ns = 5 if five else 9
    rows, cols, h, m = strip.up_region(five, sweeps)
    assert (h, m) == (f["up_halo"](ns, sweeps), f["up_margin"](ns, sweeps))
    assert (rows, cols) == (f["up_rows"](ns, sweeps), f["up_cols"](ns, sweeps))
    assert h == (2 if five else 4) * sweeps and m % 4 == 0 and 0 <= m - h < 4
    box_rows, box_cols, row0, col0 = strip.up_box(five, sweeps)
    assert (box_rows, box_cols) == (f["up_box_rows"](ns, sweeps), f["up_box_cols"](ns, sweeps))
    assert col0 == f["up_box_col0"](ns, sweeps) and col0 % 4 == 0 and box_cols % 4 == 0
    assert row0 == -(h // 2) - 1
    assert "I0 = ti0 / 2 - H / 2 - 1, J0 = tj0 / 2 + up_box_col0(NS, SWEEPS);" in _src("strip.cu")
    nbytes = 4 * f["up_smem_floats"](ns, sweeps)
    assert strip.up_smem_bytes(five, sweeps) == nbytes <= BLOCK_SMEM
    assert "__launch_bounds__(down_threads(NS)) strip_up_kernel" in _src("strip.cu")
    if sweeps == 1:
        assert nbytes == (75776 if five else 130240)
        blocks = 3 if five else 1
        assert (nbytes + 1024) * blocks <= SM_SMEM < (nbytes + 1024) * (blocks + 1)
        assert blocks * strip.down_threads(five) <= 2048


def _taps(five):
    taps = [(1, 0), (-1, 0), (0, 1), (0, -1)]
    return taps + ([] if five else [(1, 1), (-1, 1), (1, -1), (-1, -1)])


@pytest.mark.parametrize("five", [True, False], ids=["five", "nine"])
@pytest.mark.parametrize("sweeps", [0, 1, 2])
def test_k2b_stages_every_cell_it_reads(five, sweeps):
    """A model of strip_up's tile on a 128 x 192 level (every tile of the
    grid, so the edges' clamps and zero padding are met): the prolongation
    adds the correction to every on-grid slot of the logical region, each
    read of the coarse correction (the cell and its clamped neighbours)
    lies in the box on the coarse grid; each colour pass updates its
    colour's on-grid cells of the shrinking region, reads b and the
    stencil there inside the staged rows 1..RI-2 and columns QLO..QHI-1,
    and reads p only from region slots that are off the grid (zeros) or
    carry the correction; the last pass leaves exactly the owned tile."""
    src = _src("strip.cu")
    rows, cols, h, m = strip.up_region(five, sweeps)
    box_rows, box_cols, row0, col0 = strip.up_box(five, sweeps)
    tile, tj = strip.TILE, strip.DOWN_TILE_J
    qlo_expr, qhi_expr = re.search(r"constexpr int QLO = (.*?), QHI = (.*?);", src).groups()
    env = {"M": m, "H": h, "TJ": tj}
    qlo, qhi = (eval(e.replace("/", "//"), {}, env) for e in (qlo_expr, qhi_expr))  # noqa: S307
    colors = 2 if five else 4
    nx, ny = 128, 192
    nci, ncj = nx // 2, ny // 2
    for ti0 in range(0, nx, tile):
        for tj0 in range(0, ny, tj):
            i0, j0 = ti0 - h, tj0 - m
            I0, J0 = ti0 // 2 + row0, tj0 // 2 + col0
            corrected = set()
            for r in range(rows):
                for q in range(m - h, m + tj + h):
                    gi, gj = i0 + r, j0 + q
                    if not (0 <= gi < nx and 0 <= gj < ny):
                        continue
                    corrected.add((r, q))
                    I, J = gi // 2, gj // 2
                    Ia = min(I + 1, nci - 1) if gi % 2 else max(I - 1, 0)
                    Ja = min(J + 1, ncj - 1) if gj % 2 else max(J - 1, 0)
                    for a in (I, Ia):
                        for b in (J, Ja):
                            assert 0 <= a - I0 < box_rows and 0 <= b - J0 < box_cols
                            assert 0 <= a < nci and 0 <= b < ncj
            updated = {}
            for n in range(1, colors * sweeps + 1):
                c = (n - 1) % colors
                for r in range(n, rows - n):
                    for q in range(m - h + n, m + tj + h - n):
                        gi, gj = i0 + r, j0 + q
                        color = (gi + gj) % 2 if five else 2 * (gi % 2) + gj % 2
                        if color != c or not (0 <= gi < nx and 0 <= gj < ny):
                            continue
                        assert 1 <= r < rows - 1 and qlo <= q < qhi
                        for di, dj in _taps(five):
                            rr, qq = r + di, q + dj
                            assert 0 <= rr < rows and 0 <= qq < cols
                            on = 0 <= i0 + rr < nx and 0 <= j0 + qq < ny
                            assert not on or (rr, qq) in corrected
                        updated[(gi, gj)] = updated.get((gi, gj), 0) + 1
            owned = {(gi, gj) for gi in range(ti0, ti0 + tile) for gj in range(tj0, tj0 + tj)}
            assert all(updated.get(cell, 0) == sweeps for cell in owned)


def _stencil(n, five, seed=5):
    rng = np.random.default_rng(seed)
    arrays = {k: torch.as_tensor(rng.normal(size=(n, n)), dtype=torch.float32) for k in NAMES}
    if five:
        for k in NAMES[5:]:
            arrays[k] = torch.zeros(n, n)
    return Stencil9(**arrays)


@pytest.mark.parametrize("five", [True, False], ids=["five", "nine"])
def test_k2b_wrapper_reuses_host_arrays_and_allocates_once(recorder, five):
    """Through a recording library: one pointer array per (shape, five,
    sweeps), the slots in up_slots' order, the output a fresh tensor a call
    (no other allocation); a new shape gets its own arrays."""
    n = 64
    st = _stencil(n, five)
    p, b, ec = torch.zeros(n, n), torch.ones(n, n), torch.ones(n // 2, n // 2)
    cfg = MultigridConfig(pre_smoothing=1, post_smoothing=2, omega=1.2)
    out1 = strip.strip_up(p, b, st, ec, cfg, five)
    out2 = strip.strip_up(p, b, st, ec, cfg, five)
    strip.strip_up(torch.zeros(32, 32), torch.zeros(32, 32), _stencil(32, five),
                   torch.zeros(16, 16), cfg, five)
    (e1, p1, ip1, fp1, s1, a1, i1, f1), (_, p2, ip2, _, _, a2, i2, f2), (_, _, ip3, _, _, a3,
                                                                          _, _) = recorder.calls
    assert e1 == "nf_strip_up" and s1 == 7 and fp1 == pytest.approx([1.2])
    assert a1 is a2 and i1 is i2 and f1 is f2 and a3 is not a1
    assert ip1 == ip2 == [n, n, int(five), 2] and ip3 == [32, 32, int(five), 2]
    names = strip.up_slots(five)
    arrays = [getattr(st, k) for k in names[2:-2]]
    assert p1 == [p.data_ptr(), b.data_ptr(), *[a.data_ptr() for a in arrays], ec.data_ptr(),
                  out1.data_ptr()]
    assert p2[-1] == out2.data_ptr() != out1.data_ptr() and p2[:-1] == p1[:-1]
    assert tuple(out1.shape) == (n, n) and strip.STRIP_UP_LAUNCHES == 3


# ---------------------------------------------------------------------------
# K4: the C entry, the output buffer and the wrapper


def test_k4_slots_match_c_entry():
    """nf_galerkin_levels' slots: the fine stencil's nine pointers (zeros
    for absent corners), then nine outputs a coarse level in Stencil9's
    field order; L, fine_five, then (ni, nj) a level; one cluster launch."""
    src = _src("mg.cu")
    doc = re.search(r"// ptrs: (.*)\n//\s+(.*)\n// ip:   (.*)\nNF_EXPORT int nf_galerkin_levels\(",
                    src)
    assert f"{doc.group(1)} {doc.group(2)}" == (
        "the fine stencil (9 pointers, 0 for absent corners), then 9 output arrays per "
        "coarse level (c, e, w, n, s, ne, nw, se, sw)")
    assert doc.group(3) == "L (levels, fine included), fine_five, then per level ni, nj"
    entry = _body(src, "NF_EXPORT int nf_galerkin_levels(")
    assert "read_rap(P, ptrs, ip)" in entry
    entry += _body(src, "int read_rap(")  # the slots it reads through
    assert "P.L = ip[0];" in entry
    assert "lv.st[k] = reinterpret_cast<const float*>(ptrs[9 * l + k]);" in entry
    assert "lv.ni = ip[2 + 2 * l]; lv.nj = ip[3 + 2 * l];" in entry
    assert "lv.five = l == 0 ? ip[1] : 0;" in entry
    assert "nf_cluster_launch(galerkin_kernel, size, P, 0, (cudaStream_t)stream)" in entry
    assert tuple(f.name for f in Stencil9.__dataclass_fields__.values()) == NAMES
    kernel = _body(src, "__global__ void __launch_bounds__(NF_CL_THREADS, 1) galerkin_kernel(")
    assert "nf_cl_galerkin_rap(C, P.lv, P.L);" in kernel


@pytest.mark.parametrize("n", [15, 63, 255])
def test_k4_buffer_layout(n):
    """rap_layout: per coarse level nine arrays a pitch apart, each pitch
    the level's cells rounded up to 64 floats, so every view starts on a
    256-byte boundary; the levels follow each other without overlap."""
    shapes = [(n, n)]
    while shapes[-1][0] > 7:
        shapes.append(((shapes[-1][0] - 1) // 2,) * 2)
    levels, total = mg.rap_layout(shapes)
    end = 0
    for (off, pitch), (ni, nj) in zip(levels, shapes[1:]):
        assert off == end and pitch >= ni * nj and pitch - ni * nj < mg.RAP_ALIGN
        assert (4 * off) % 256 == 0 and (4 * pitch) % 256 == 0
        end = off + 9 * pitch
    assert total == end


def test_k4_wrapper_reuses_host_arrays_and_allocates_once(recorder):
    """Through a recording library: one pointer / int / float array set per
    hierarchy; the fine slots hold the stencil (zeros for a 5-point
    fine's corners), the output slots the views of one fresh buffer a call
    at rap_layout's offsets; the Stencil9s returned are those views."""
    shapes = [(31, 31), (15, 15), (7, 7)]
    fine = _stencil(31, True)
    out1 = mg.galerkin_levels(fine, shapes, True)
    out2 = mg.galerkin_levels(fine, shapes, True)
    mg.galerkin_levels(_stencil(15, False), shapes[1:], False)
    (e1, p1, ip1, fp1, s1, a1, i1, f1), (_, p2, ip2, _, _, a2, i2, f2), (_, p3, ip3, _, _, a3,
                                                                          _, _) = recorder.calls
    assert e1 == "nf_galerkin_levels" and s1 == 7 and mg.RAP_LAUNCHES == 3
    assert a1 is a2 and i1 is i2 and f1 is f2 and a3 is not a1
    assert ip1 == ip2 == [3, 1, 31, 31, 15, 15, 7, 7] and ip3 == [2, 0, 15, 15, 7, 7]
    assert p1[:9] == [getattr(fine, k).data_ptr() for k in NAMES[:5]] + [0] * 4
    assert len(p1) == 27 and len(p3) == 18
    levels, total = mg.rap_layout(shapes)
    for ptrs, out in ((p1, out1), (p2, out2)):
        base = out[0].c.untyped_storage().data_ptr()
        assert out[0].c.untyped_storage().nbytes() == 4 * total
        views = [getattr(st, k) for st in out for k in NAMES]
        assert ptrs[9:] == [v.data_ptr() for v in views]
        for v, (lvl, k) in zip(views, [(lvl, k) for lvl in range(2) for k in range(9)]):
            off, pitch = levels[lvl]
            assert v.data_ptr() == base + 4 * (off + k * pitch)
            assert v.is_contiguous() and tuple(v.shape) == shapes[lvl + 1]
            assert v.untyped_storage().data_ptr() == base
    assert p1[9:] != p2[9:]


# ---------------------------------------------------------------------------
# K4: the RAP's arithmetic against the plain chain and the Pallas kernel

KI = (0, 1, -1, 0, 0, 1, -1, 1, -1)
KJ = (0, 0, 0, 1, -1, 1, 1, -1, -1)
W3 = (np.float32(0.25), np.float32(0.5), np.float32(0.25))


def _axis_weights(idx, d, nc):
    """nf_cl_axis_weights over the coarse lines ``idx``: the prolongation
    weight of fine line 2I - 1 + e to coarse line I + d, e = 0..4."""
    one, half, zero = np.ones(idx.shape, np.float32), np.full(idx.shape, 0.5, np.float32), \
        np.zeros(idx.shape, np.float32)
    if d == -1:
        return [one, half, zero, zero, zero]
    if d == 1:
        return [zero, zero, zero, half, one]
    return [zero, np.where(idx == 0, one, half), one, np.where(idx == nc - 1, one, half), zero]


def _rap_model(st, taps):
    """One coarse level from the fine stencil ``st`` (nine float32 arrays)
    by nf_cl_rap_pass's loops: s over the taps, row over b, val over a, all
    in float32, zero where the coarse neighbour is off the grid."""
    nf_ = st[0].shape[0]
    nc = (nf_ - 1) // 2
    idx = np.arange(nc)
    out = []
    for o in range(9):
        wi, wj = _axis_weights(idx, KI[o], nc), _axis_weights(idx, KJ[o], nc)
        val = np.zeros((nc, nc), np.float32)
        for a in range(3):
            row = np.zeros((nc, nc), np.float32)
            for b in range(3):
                s = np.zeros((nc, nc), np.float32)
                for k in range(taps):
                    f = st[k][a:a + 2 * nc:2, b:b + 2 * nc:2]
                    s = s + f * (wi[a + KI[k] + 1][:, None] * wj[b + KJ[k] + 1][None, :])
                row = row + W3[b] * s
            val = val + W3[a] * row
        inside = (((idx + KI[o] >= 0) & (idx + KI[o] < nc))[:, None]
                  & ((idx + KJ[o] >= 0) & (idx + KJ[o] < nc))[None, :])
        out.append(np.where(inside, val, np.float32(0)))
    return out


def test_k4_model_follows_the_c_loops():
    """The model's statements are nf_cl_rap_pass's and nf_cl_axis_weights'."""
    src = _src("cluster.cuh")
    body = _body(src, "__device__ inline void nf_cl_rap_pass(")
    for line in ("constexpr int KI[9] = {0, 1, -1, 0, 0, 1, -1, 1, -1};",
                 "constexpr int KJ[9] = {0, 0, 0, 1, -1, 1, 1, -1, -1};",
                 "constexpr float W[3] = {0.25f, 0.5f, 0.25f};",
                 "s = s + F.st[k][fg] * (wi[a + KI[k] + 1] * wj[b + KJ[k] + 1]);",
                 "row = row + W[b] * s;", "val = val + W[a] * row;",
                 "if (Ic >= 0 && Ic < C.ni && Jc >= 0 && Jc < C.nj) {"):
        assert line in body, line
    weights = _body(src, "__device__ __forceinline__ void nf_cl_axis_weights(")
    for line in ("w[0] = d == -1 ? 1.f : 0.f;",
                 "w[1] = d == -1 ? 0.5f : (d == 0 ? (I == 0 ? 1.f : 0.5f) : 0.f);",
                 "w[2] = d == 0 ? 1.f : 0.f;",
                 "w[3] = d == 1 ? 0.5f : (d == 0 ? (I == nc - 1 ? 1.f : 0.5f) : 0.f);",
                 "w[4] = d == 1 ? 1.f : 0.f;"):
        assert line in weights, line


def _hierarchy(n, seed=5):
    rng = np.random.default_rng(seed)
    d_u = torch.as_tensor(rng.random((n + 1, n)) + 0.5, dtype=torch.float32)
    d_v = torch.as_tensor(rng.random((n, n + 1)) + 0.5, dtype=torch.float32)
    return build_levels(d_u, d_v, MultigridConfig(), dx=1.0 / (n - 1), dy=1.0 / (n - 1),
                        rho=1.0, variant="consistent")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-30)


@pytest.mark.parametrize("n,fine", [(31, 0), (63, 0), (63, 1)],
                         ids=["31-five", "63-five", "31-nine"])
def test_k4_model_matches_plain_and_pallas(n, fine):
    """The float32 model of the cluster RAP, level by level from the fine
    stencil (5-point level 0 of a 31^2 and a 63^2 hierarchy, and the
    9-point 31^2 level 1 of the 63^2 one), equals galerkin_levels_plain
    (which a CPU tensor runs: no launch) and the Pallas kernel in
    interpret mode to 1e-5 of each array's scale (tests/test_pallas.py's
    K4 tolerance)."""
    levels = _hierarchy(n)[fine:]
    shapes = [lv[1] for lv in levels]
    five = fine == 0
    fine_st = levels[0][0]
    launches = mg.RAP_LAUNCHES
    plain = mg.galerkin_levels(fine_st, shapes, five)
    assert mg.RAP_LAUNCHES == launches
    jst = JStencil9(**{k: jnp.asarray(getattr(fine_st, k).numpy()) for k in NAMES})
    pallas = j_rap(jst, shapes, five, interpret=True)
    st = [getattr(fine_st, k).numpy() for k in NAMES]
    assert len(plain) == len(pallas) == len(shapes) - 1
    for lvl, (p_lvl, j_lvl) in enumerate(zip(plain, pallas)):
        model = _rap_model(st, 5 if five and lvl == 0 else 9)
        for k, name in enumerate(NAMES):
            assert _rel(model[k], getattr(p_lvl, name).numpy()) < 1e-5, (lvl, name)
            assert _rel(model[k], getattr(j_lvl, name)) < 1e-5, (lvl, name)
        st = model
