"""K11 (``csrc/poisson.cu``) of the PyTorch port, on the CPU.

K11a runs temporally blocked tiles: each block stages its tile and a halo of
H = 2 S cells of p, b, the links and diag into shared memory and runs the
2 S colour passes there.  A float32 numpy model of that tiling, its tile
shape, ``RB_S_MAX`` and halo rule parsed from the source, runs every tile
on its own staged region (zeros off the grid), keeps only the owned cells,
and must reproduce ``rbgs_sweeps_plain`` bit for bit, a call of more than
``RB_S_MAX`` sweeps through its ping-pong of launches included; the model
also shows that every slot a pass reads was staged.  The C entries' slots
of K11a and K11b (parsed) against what the wrappers pass, through a
recording library; each entry's one launch; a K11a call's operators (only
its output's allocation) and its chain of launches.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from naviflow_tpu_torch.ops import _cuda, kernels
from naviflow_tpu_torch.ops.poisson import PoissonCoeffs, poisson_coefficients

torch.set_num_threads(2)

CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"
SRC = (CSRC / "poisson.cu").read_text()
ARRAYS = ("p", "b", "a_e", "a_w", "a_n", "a_s", "diag")


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _body(signature):
    start = SRC.index(signature)
    return SRC[start:SRC.index("\n}\n", start)]


class Geometry:
    """The tile of poisson.cu: its owned shape, RB_S_MAX, and the rb_*
    helpers (halo, margin, rows, columns, shared floats) evaluated from the
    source, with the ring rule's QLO / QHI."""

    def __init__(self):
        self.ti, self.tj = _constant("RB_TI"), _constant("RB_TJ")
        self.threads = _constant("RB_THREADS")
        self.s_max = _constant("RB_S_MAX")
        helpers = dict(re.findall(
            r"constexpr int (rb_\w+)\(int s\) \{\s*return (.*?);\s*\}", SRC, re.S))
        assert set(helpers) == {"rb_halo", "rb_margin", "rb_rows", "rb_cols", "rb_smem_floats"}
        consts = {"RB_TI": self.ti, "RB_TJ": self.tj, "RB_ARRAYS": len(ARRAYS)}
        self._f = {}
        for name, expr in helpers.items():
            py = re.sub(r"(rb_\w+)\(", r"_f_\1(", " ".join(expr.split())).replace("/", "//")
            self._f[name] = (lambda s, py=py: eval(  # noqa: S307
                py, {f"_f_{k}": v for k, v in self._f.items()}, {**consts, "s": s}))
        qlo, qhi = re.search(r"constexpr int QLO = (.*?), QHI = (.*?);", SRC).groups()
        self._q = [e.replace("/", "//") for e in (qlo, qhi)]

    def region(self, s):
        """(H, M, RI, W, QLO, QHI) of the S-sweep instance."""
        h, m = self._f["rb_halo"](s), self._f["rb_margin"](s)
        env = {"H": h, "M": m, "RB_TJ": self.tj}
        qlo, qhi = (eval(e, {}, env) for e in self._q)  # noqa: S307
        return h, m, self._f["rb_rows"](s), self._f["rb_cols"](s), qlo, qhi

    def smem_bytes(self, s):
        return 4 * self._f["rb_smem_floats"](s)

    def chunks(self, n_sweeps):
        """The sweeps of each launch of a call, as rbgs_sweeps splits it."""
        full, rest = divmod(n_sweeps, self.s_max)
        return [self.s_max] * full + ([rest] if rest else [])


GEO = Geometry()


def _tile_launch(src, rest, s, omega, reads=None):
    """One launch of the S-sweep instance over every tile: stage, 2 S
    passes, keep the owned cells.  ``reads`` (a list) collects, per tile,
    the staged masks and every slot a pass read, for the staging check."""
    nx, ny = src.shape
    h, m, ri, w, qlo, qhi = GEO.region(s)
    out = np.full_like(src, np.nan)
    om = np.float32(omega)
    rr, qq = np.meshgrid(np.arange(ri), np.arange(w), indexing="ij")
    for ti0 in range(0, nx, GEO.ti):
        for tj0 in range(0, ny, GEO.tj):
            i0, j0 = ti0 - h, tj0 - m
            gi, gj = i0 + rr, j0 + qq
            on = (gi >= 0) & (gi < nx) & (gj >= 0) & (gj < ny)
            inner = (rr >= 1) & (rr < ri - 1) & (qq >= qlo) & (qq < qhi)
            staged = [np.ones_like(on)] + [inner] * 6
            planes = []
            for a, mask in zip((src, *rest), staged):
                x = np.zeros((ri, w), np.float32)
                x[mask & on] = a[gi[mask & on], gj[mask & on]]
                planes.append(x)
            sp, sb, se, sw, sn, ss, sd = planes
            read = np.zeros((len(ARRAYS), ri, w), bool)
            count = np.zeros((ri, w), int)
            for n in range(1, 2 * s + 1):
                c = (n - 1) % 2
                upd = ((rr >= n) & (rr < ri - n) & (qq >= m - h + n) & (qq < m + GEO.tj + h - n)
                       & ((rr + qq) % 2 == c) & on)
                r, q = np.nonzero(upd)
                for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    read[0, r + di, q + dj] = True
                read[:, r, q] = True
                count[r, q] += 1
                x = sp[r, q]
                total = (se[r, q] * sp[r + 1, q] + sw[r, q] * sp[r - 1, q]
                         + sn[r, q] * sp[r, q + 1] + ss[r, q] * sp[r, q - 1])
                invd = sd[r, q]
                if n <= 2:
                    invd = np.float32(1) / np.where(invd < np.float32(1e-15), np.float32(1), invd)
                    sd[r, q] = invd
                pnew = (sb[r, q] + total) * invd
                sp[r, q] = x + om * (pnew - x)
            own = (rr >= h) & (rr < h + GEO.ti) & (qq >= m) & (qq < m + GEO.tj) & on
            out[gi[own], gj[own]] = sp[own]
            if reads is not None:
                reads.append((staged, on, read, count, own, planes))
    return out


def rbgs_tile_model(p, b, c: PoissonCoeffs, n_sweeps, omega, reads=None):
    rest = [t.numpy() for t in (b, c.a_e, c.a_w, c.a_n, c.a_s, c.diag)]
    x = p.numpy()
    for s in GEO.chunks(n_sweeps):
        x = _tile_launch(x, rest, s, omega, reads)
    return x


def _system(nx, ny, seed=11):
    """A consistent-variant operator from seeded d-fields (float32), p, b."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    c = poisson_coefficients(t(rng.random((nx + 1, ny)) + 0.2), t(rng.random((nx, ny + 1)) + 0.2),
                             dx=0.05, dy=0.05, rho=1.0, variant="consistent")
    return t(rng.normal(size=(nx, ny))), t(rng.normal(size=(nx, ny))), c


SHAPES = [(63, 63), (48, 96), (64, 64), (7, 64), (64, 5)]


def test_tile_geometry():
    """The parsed tile: 16 x 16 owned cells, RB_S_MAX = 4, halo 2 S, margin
    H rounded up to 4; 512 threads, whole warps, at least the cells of one
    colour in the widest pass (pass 1 at S = RB_S_MAX), so every pass is one
    round; every instance within the 48 KB of static shared memory (28,672
    bytes at S = 4)."""
    assert (GEO.ti, GEO.tj, GEO.s_max) == (16, 16, kernels.RBGS_S_MAX) == (16, 16, 4)
    h = 2 * GEO.s_max
    widest = (GEO.ti + 2 * h - 2) * (GEO.tj + 2 * h - 2) // 2
    assert GEO.threads == 512 and GEO.threads % 32 == 0 and widest <= GEO.threads
    assert "__launch_bounds__(RB_THREADS) rbgs_tile_kernel(RbParams P)" in SRC
    for s in range(1, GEO.s_max + 1):
        h, m, ri, w, qlo, qhi = GEO.region(s)
        assert h == 2 * s and m % 4 == 0 and 0 <= m - h < 4 and w % 4 == 0
        assert (ri, w) == (GEO.ti + 2 * h, GEO.tj + 2 * m)
        assert qlo % 4 == 0 and qhi % 4 == 0 and qlo <= m - h + 1 and qhi >= m + GEO.tj + h - 1
        assert GEO.smem_bytes(s) == 4 * 7 * ri * w <= 48 * 1024
    assert GEO.smem_bytes(4) == 28672
    kernel = _body("__global__ void __launch_bounds__(RB_THREADS) rbgs_tile_kernel(")
    # the passes the model runs: rows [n, RI - n), columns [M - H + n, M + RB_TJ + H - n)
    assert "for (int n = 1; n <= 2 * S; ++n) {" in kernel
    assert "const int per = (RB_TJ + 2 * H - 2 * n) / 2, q_lo = M - H + n;" in kernel
    assert "k < (RI - 2 * n) * per;" in kernel and "const int r = n + k / per" in kernel
    assert "const int q = q0 + ((c + r + q0) & 1);" in kernel
    assert "rb_update<R::PLANE, W>(s, r * W + q, P.omega, n <= 2);" in kernel
    update = _body("__device__ __forceinline__ void rb_update(")
    assert "invd = 1.f / (invd < 1e-15f ? 1.f : invd);" in update
    assert "const float pnew = (s[PLANE + k] + sum) * invd;" in update
    assert "s[k] = x + omega * (pnew - x);" in update


@pytest.mark.parametrize("sweeps", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}x{b}" for a, b in SHAPES])
def test_tile_model_matches_plain(shape, sweeps):
    """Each tile on its own staged region, owned cells kept: bit-equal to
    ``rbgs_sweeps_plain`` at every sweep count of one launch."""
    p, b, c = _system(*shape)
    want = kernels.rbgs_sweeps_plain(p, b, c, sweeps, 1.5).numpy()
    got = rbgs_tile_model(p, b, c, sweeps, 1.5)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}x{b}" for a, b in SHAPES])
def test_tile_model_chunked_matches_plain(shape):
    """RB_S_MAX + 2 sweeps: two launches (RB_S_MAX, then 2) through the
    ping-pong, bit-equal to the plain sweeps; another omega too."""
    n = GEO.s_max + 2
    assert GEO.chunks(n) == [GEO.s_max, 2]
    p, b, c = _system(*shape, seed=12)
    for omega in (1.5, 1.3):
        want = kernels.rbgs_sweeps_plain(p, b, c, n, omega).numpy()
        got = rbgs_tile_model(p, b, c, n, omega)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("sweeps", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(63, 63), (64, 5), (96, 130)], ids=["63x63", "64x5", "96x130"])
def test_tile_model_stages_every_slot_it_reads(shape, sweeps):
    """Every slot any pass reads (p at the cell and its four neighbours;
    b, the links and diag at the cell) lies in the region and was staged;
    no staged slot off the grid holds anything but 0; each owned cell is
    updated exactly once a sweep."""
    p, b, c = _system(*shape, seed=13)
    reads = []
    rbgs_tile_model(p, b, c, sweeps, 1.5, reads)
    assert len(reads) == -(-shape[0] // GEO.ti) * -(-shape[1] // GEO.tj)
    for staged, on, read, count, own, planes in reads:
        for a in range(len(ARRAYS)):
            assert not (read[a] & ~staged[a]).any(), ARRAYS[a]
            assert not planes[a][staged[a] & ~on].any(), ARRAYS[a]
        assert (count[own] == sweeps).all()
        assert not count[~on].any()


# ---------------------------------------------------------------------------
# the C entries and the wrappers


def _params(entry):
    """(type, name) of each parameter of the C entry ``entry``."""
    args = re.search(rf"NF_EXPORT int {entry}\((.*?)\)\s*\{{", SRC, re.S).group(1)
    out = []
    for arg in " ".join(args.split()).split(", "):
        typ, name = re.match(r"(.*?)\s*(\w+)$", arg).groups()
        out.append((typ.replace("const ", "").replace(" ", ""), name))
    return out


CTYPE = {"float*": "c_void_p", "void*": "c_void_p", "int": "c_int", "float": "c_float"}


@pytest.mark.parametrize("entry, names", [
    ("nf_rbgs_sweeps", ["p", "b", "ae", "aw", "an", "as", "diag", "out", "nx", "ny",
                        "n_sweeps", "omega", "stream"]),
    ("nf_apply_poisson", ["p", "ae", "aw", "an", "as", "diag", "out", "nx", "ny", "stream"])])
def test_c_entry_slots_match_signatures(entry, names):
    """The lean calls: the C parameters (parsed) in the order the wrapper
    passes them, each with the ctypes type _cuda declares for it."""
    params = _params(entry)
    assert [n for _, n in params] == names
    declared = [t.__name__ for t in _cuda._SIGNATURES[entry]]
    assert declared == [CTYPE[t] for t, _ in params]
    assert entry not in _cuda._KERNELS


@pytest.mark.parametrize("entry", ["nf_rbgs_sweeps", "nf_apply_poisson"])
def test_each_c_call_launches_one_kernel(entry):
    """Each entry holds one launch and no loop around it (K11a's one loop is
    the one-line alignment test), so the wrappers' one count a C call is one
    count a launch; K11a's refuses more than RB_S_MAX sweeps (it has no
    instance for them) and an output that is its input."""
    body = _body(f"NF_EXPORT int {entry}(")
    assert body.count("<<<") == 1 and "while" not in body and "goto" not in body
    loops = [line.strip() for line in body.splitlines() if re.search(r"\bfor\b", line)]
    assert all(line.endswith(";") and "{" not in line for line in loops), loops
    if entry == "nf_rbgs_sweeps":
        assert "n_sweeps < 1 || n_sweeps > RB_S_MAX" in body and "out == p" in body
        assert "kRbKernels[n_sweeps - 1]<<<" in body


def test_launch_floor_probe_signature():
    src = (CSRC / "step.cu").read_text()
    assert "NF_EXPORT int nf_launch_floor_probe(int blocks, int threads, void* stream) {" in src
    assert "launch_floor_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();" in src
    assert [t.__name__ for t in _cuda._SIGNATURES["nf_launch_floor_probe"]] == [
        "c_int", "c_int", "c_void_p"]


class _Recorder:
    """Records every argument of the lean calls."""

    def __init__(self):
        self.calls = []

    def nf_rbgs_sweeps(self, *args):
        self.calls.append(("nf_rbgs_sweeps", args))
        return 0

    def nf_apply_poisson(self, *args):
        self.calls.append(("nf_apply_poisson", args))
        return 0


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_cuda, "kernel_device", lambda x: True)
    monkeypatch.setattr(_cuda, "require", lambda *a: None)
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_of", lambda x: 7)
    monkeypatch.setattr(kernels, "RBGS_LAUNCHES", 0)
    monkeypatch.setattr(kernels, "MATVEC_LAUNCHES", 0)
    return lib


def test_wrappers_pass_the_c_slots(recorder):
    """rbgs_sweeps: p, b, the four links, diag (not invd: the kernel divides),
    the output; nx, ny, the launch's sweeps; omega; the stream.  Above
    RB_S_MAX sweeps the first launch reads p into a second buffer and the
    next reads that buffer into the output.  apply_poisson_kernel: p, the
    links, diag, the output; nx, ny; the stream."""
    p, b, c = _system(48, 96)
    links = [c.a_e, c.a_w, c.a_n, c.a_s, c.diag]
    out = kernels.rbgs_sweeps(p, b, c, n_sweeps=3, omega=1.2)
    out6 = kernels.rbgs_sweeps(p, b, c, n_sweeps=6, omega=1.5)
    mv = kernels.apply_poisson_kernel(p, c)
    (e1, a1), (e2, a2), (e3, a3), (e4, a4) = recorder.calls
    assert e1 == e2 == e3 == "nf_rbgs_sweeps" and e4 == "nf_apply_poisson"
    rest = [b.data_ptr(), *[t.data_ptr() for t in links]]
    assert list(a1) == [p.data_ptr(), *rest, out.data_ptr(), 48, 96, 3, 1.2, 7]
    tmp = a2[7]
    assert tmp not in (None, 0, out6.data_ptr(), p.data_ptr())
    assert list(a2) == [p.data_ptr(), *rest, tmp, 48, 96, GEO.s_max, 1.5, 7]
    assert list(a3) == [tmp, *rest, out6.data_ptr(), 48, 96, 6 - GEO.s_max, 1.5, 7]
    assert list(a4) == [p.data_ptr(), *[t.data_ptr() for t in links], mv.data_ptr(), 48, 96, 7]
    assert (kernels.RBGS_LAUNCHES, kernels.MATVEC_LAUNCHES) == (1 + 2, 1)


class _Ops(TorchDispatchMode):
    """The PyTorch operators dispatched inside the mode."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket.__name__))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n_sweeps", range(0, 10))
def test_one_allocation_and_launches_per_call(recorder, n_sweeps):
    """The gate forced open: a call of 1..RB_S_MAX sweeps dispatches one
    ``empty`` (its output) and nothing else (no where, ones_like or
    reciprocal: the kernel computes invd) and makes one C call, one launch;
    above, a second ``empty`` and ceil(n / RB_S_MAX) C calls, each counted,
    chained so that each reads the one before's output and the last writes
    the call's; no sweep, a copy and no launch."""
    p, b, c = _system(32, 32)
    with _Ops() as ops:
        out = kernels.rbgs_sweeps(p, b, c, n_sweeps=n_sweeps, omega=1.5)
    chunks = GEO.chunks(n_sweeps)
    assert kernels.RBGS_LAUNCHES == len(recorder.calls) == len(chunks) == -(-n_sweeps // 4)
    if n_sweeps == 0:
        assert ops.names == ["clone"] and torch.equal(out, p) and out is not p
        return
    assert ops.names == ["empty"] * min(len(chunks), 2)
    assert [args[10] for _, args in recorder.calls] == chunks
    srcs = [args[0] for _, args in recorder.calls]
    dsts = [args[7] for _, args in recorder.calls]
    assert srcs == [p.data_ptr(), *dsts[:-1]] and dsts[-1] == out.data_ptr()
    assert all(s != d for s, d in zip(srcs, dsts))


def test_gate_and_cpu_path():
    """On CPU tensors every call runs the plain version (no launch), any
    sweep count; more than 256^2 cells or float64 would too (the gate's
    rule, held in tests/test_torch_poisson_kernels.py)."""
    p, b, c = _system(40, 24)
    r0 = kernels.RBGS_LAUNCHES
    for n in (0, 1, 5):
        assert torch.equal(kernels.rbgs_sweeps(p, b, c, n_sweeps=n, omega=1.5),
                           kernels.rbgs_sweeps_plain(p, b, c, n, 1.5))
    assert kernels.RBGS_LAUNCHES == r0
    assert kernels._use_kernel(torch.empty(256, 256, device="meta")) is False
    assert kernels.PALLAS_MAX_CELLS == 256 * 256
