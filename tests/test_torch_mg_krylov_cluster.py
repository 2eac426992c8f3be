"""The whole-solve multigrid kernel K5 and the masked BiCGSTAB kernel K7 of
the PyTorch port, on the CPU: their launch plumbing held against the C
entries (``csrc/mg.cu`` / ``csrc/vcycle.cuh``, ``csrc/krylov.cu``, parsed
from the source); K5's shared-memory sizing on every hierarchy its gate
admits; K7's band split and shared memory per shape; the wrappers' reuse
of their host arrays and scratch across calls (through a library that
records its calls); and the guard that CPU tensors still run the plain
versions and agree with the JAX package's Pallas kernels in interpret mode.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naviflow_tpu.ops.pallas_krylov import bicgstab_momentum_pallas as j_bicgstab
from naviflow_tpu.ops.pallas_mg import fused_mg_solve as j_mg_solve
from naviflow_tpu.ops.powerlaw import relax_coefficients, u_momentum_coefficients
from naviflow_tpu.solvers.multigrid import MultigridConfig as JMG
from naviflow_tpu.solvers.multigrid import build_levels as j_build_levels

import naviflow_tpu as nf
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops import _cuda, krylov, mg
from naviflow_tpu_torch.ops.stencil import StencilCoeffs
from naviflow_tpu_torch.ops.stencil9 import Stencil9
from naviflow_tpu_torch.solvers.multigrid import MultigridConfig, _level_transfers
from naviflow_tpu_torch.solvers.multigrid import build_levels as t_build_levels

torch.set_num_threads(2)

CSRC = Path(mg.__file__).resolve().parent.parent / "csrc"
_NAMES = ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")


def _src(name):
    return (CSRC / name).read_text()


def _constant(name, path):
    return int(re.search(rf"constexpr int {name} = (\d+);", _src(path)).group(1))


def _enum(name, path):
    body = re.search(rf"enum {name} \{{([^}}]*)\}}", _src(path)).group(1)
    return [e.split("=")[0].strip() for e in body.split(",") if e.strip()]


def _shapes(n, coarsest=7):
    """A square hierarchy's level shapes by the solver's coarsening rule."""
    cfg = MultigridConfig(coarsest_grid_size=coarsest)
    shapes = [(n, n)]
    while min(shapes[-1]) > coarsest:
        shapes.append(_level_transfers(*shapes[-1], cfg)[2])
    return shapes


def _levels(shapes, seed=0):
    """A hierarchy of seeded random stencils (5-point level 0, 9-point below)."""
    rng = np.random.default_rng(seed)
    out = []
    for lvl, shp in enumerate(shapes):
        arrays = {k: torch.as_tensor(rng.normal(size=shp), dtype=torch.float32)
                  for k in _NAMES}
        if lvl == 0:
            for k in ("ne", "nw", "se", "sw"):
                arrays[k] = torch.zeros(shp)
        out.append((Stencil9(**arrays), shp, lvl == 0, None))
    return out


class _Recorder:
    """Records the K5 and K7 C entries' pointer, int and float arrays."""

    def __init__(self):
        self.calls = []

    def _record(self, name, ptrs, ip, fp, stream):
        self.calls.append((name, list(ptrs), list(ip), list(fp), stream, ptrs, ip))
        return 0

    def nf_fused_mg_solve(self, *a):
        return self._record("nf_fused_mg_solve", *a)

    def nf_bicgstab(self, *a):
        return self._record("nf_bicgstab", *a)


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "require_all", lambda *a: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda x: 7)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(krylov, "cluster_size", lambda device=None: 16)
    # the launch state and counters of the fake launches stay in this test
    monkeypatch.setattr(mg, "_SOLVE", {})
    monkeypatch.setattr(krylov, "_LAUNCH", {})
    monkeypatch.setattr(mg, "SOLVE_LAUNCHES", mg.SOLVE_LAUNCHES)
    monkeypatch.setattr(krylov, "LAUNCHES", krylov.LAUNCHES)
    return lib


# ---------------------------------------------------------------------------
# K5


def _function(src, signature):
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


def _solve_entry():
    """nf_fused_mg_solve's text with ``read_solve``'s, which it reads its
    slots through."""
    src = _src("mg.cu")
    return (src[src.index("NF_EXPORT int nf_fused_mg_solve("):
                src.index("NF_EXPORT int nf_mg_solve_cluster_size(")]
            + _function(src, "int read_solve("))


def test_k5_constants_match_c_source():
    """K5's integer parameters follow K3's five (NfMsIp), its pointers after
    the levels' are the input iterate, r, cycles and rel, and its shared
    memory is the reductions' partials (cluster.cuh) before K3's levels."""
    ms = _enum("NfMsIp", "vcycle.cuh")
    assert ms[-1] == "MS_IP_LEVELS" and len(ms) - 1 == len(mg.MS_IP)
    assert [e.removeprefix("MS_IP_").lower() for e in ms[:-1]] == \
        ["max_cycles", "check_every", "mean"]
    assert "enum NfMsIp { MS_IP_MAX_CYCLES = VC_IP_LEVELS," in _src("vcycle.cuh")
    slots = _constant("NF_RED_SLOTS", "coop.cuh")
    cl_max = _constant("NF_CL_MAX", "cluster.cuh")
    assert "constexpr int NF_CL_RED_HALF = NF_RED_SLOTS * NF_CL_MAX;" in _src("cluster.cuh")
    assert "constexpr int NF_CL_RED_FLOATS = 2 * NF_CL_RED_HALF;" in _src("cluster.cuh")
    assert mg.CL_RED_FLOATS == 2 * slots * cl_max
    entry = _solve_entry()
    assert "read_levels(P.M, ptrs, ip + MS_IP_LEVELS, L)" in entry
    for k, field in enumerate(("p_in", "r", "cycles", "rel")):
        assert re.search(rf"P\.{field} = reinterpret_cast<[a-z ]+\*>\(ptrs\[11 \* L"
                         rf"{re.escape(f' + {k}') if k else ''}\]\);", entry), field
    assert "P.tol = fp[1];" in entry
    assert "sizeof(float) * (size_t)(NF_CL_RED_FLOATS + small)" in entry
    assert "nf_cluster_launch(mg_solve_kernel, size, P, smem" in entry
    # the solve reads the partials at the start of the dynamic shared memory
    assert "nf_vc_levels(M, Ls, dyn + NF_CL_RED_FLOATS, lv, &scratch_s);" in _src("vcycle.cuh")


def _gate_levels(shapes):
    """Stand-in levels for the gate: only the shapes, flags and dtype."""
    st = SimpleNamespace(c=torch.zeros(1))
    return [(st, shp, lvl == 0, None) for lvl, shp in enumerate(shapes)]


@pytest.mark.parametrize("n,first", [(63, 1), (127, 2), (255, 3), (64, 1), (256, 3)],
                         ids=["vertex63", "vertex127", "vertex255", "cell64", "cell256"])
def test_k5_shared_memory_sizing(n, first):
    """The levels in rank 0's shared memory and the launch's bytes on the
    63^2, 127^2 and 255^2 vertex and 64^2 and 256^2 cell-centred
    hierarchies: the gate admits each, and the partials and the levels of
    <= 1,024 cells fit the cluster launch's cap."""
    shapes = _shapes(n)
    cfg = MultigridConfig()
    assert mg.supports_fused(_gate_levels(shapes), cfg)
    got_first, nbytes = mg.mg_solve_layout(shapes)
    assert got_first == first
    cells = [a * b for a, b in shapes]
    assert nbytes == 4 * (mg.CL_RED_FLOATS + cells[first] + 11 * sum(cells[first:]))
    assert nbytes <= mg.SMEM_MAX
    assert max(cells[first:]) <= mg.SMALL_CELLS < cells[first - 1]


def test_k5_fits_every_hierarchy_its_gate_admits():
    """Every square hierarchy of 8^2 .. 400^2 that the gate admits (odd
    vertex, even cell-centred, and mixed chains) keeps its small levels
    within the cluster launch's shared memory; the largest admitted grids
    are 255^2 vertex and 256^2 cell-centred and above."""
    cfg = MultigridConfig()
    admitted = []
    for n in range(8, 401):
        try:
            shapes = _shapes(n)
        except ValueError:  # a mixed-parity level stops the chain
            continue
        if mg.supports_fused(_gate_levels(shapes), cfg):
            admitted.append(n)
            assert mg.mg_solve_layout(shapes)[1] <= mg.SMEM_MAX, n
    assert {63, 64, 255, 256} <= set(admitted)
    assert max(n for n in admitted if n % 2) >= 255


@pytest.mark.parametrize("n", [63, 256], ids=["vertex", "cell_centred"])
def test_k5_launch_layout_and_scratch_reuse(recorder, n):
    """Through a recording library: per level 9 stencil pointers (0 for the
    five-point level's corners), x and rhs (level 0: the fresh output p and
    b; the levels in global memory: scratch kept across calls; the
    shared-memory levels: 0), then the input iterate, r, cycles and rel (the
    two scalars one int32 pair); the integer layout of NfMsIp; the floats
    omega and the tolerance; the host arrays reused for a second call, the
    stencil slots refilled for a new hierarchy of the same shapes, and a new
    launch state for a new configuration."""
    shapes = _shapes(n)
    cfg = MultigridConfig(tolerance=1e-2, max_cycles=6, check_every=2, pre_smoothing=1,
                          post_smoothing=2, coarsest_sweeps=8, omega=1.1)
    levels = _levels(shapes)
    p0, b = torch.zeros(shapes[0]), torch.ones(shapes[0])
    out1 = mg.fused_mg_solve(p0, b, levels, cfg)
    out2 = mg.fused_mg_solve(p0, b, levels, cfg)
    new = _levels(shapes, seed=1)
    mg.fused_mg_solve(p0, b, new, cfg)
    mg.fused_mg_solve(p0, b, levels, cfg, mean_normalize=False)
    (e1, p1, ip1, fp1, s1, a1, i1), (_, p2, ip2, _, _, a2, i2), (_, p3, _, _, _, a3, _), \
        (_, _, ip4, _, _, a4, _) = recorder.calls
    L = len(shapes)
    first, _ = mg.mg_solve_layout(shapes)
    assert e1 == "nf_fused_mg_solve" and s1 == 7 and fp1 == pytest.approx([1.1, 1e-2])
    assert a1 is a2 is a3 and i1 is i2 and a4 is not a1
    assert len(p1) == 11 * L + 4 and ip1 == ip2
    assert ip1[:8] == [L, 1, 2, 8, first, 6, 2, 1] and ip4[7] == 0
    assert ip1[8:] == [m for lvl, shp in enumerate(shapes) for m in (*shp, int(lvl == 0))]
    for lvl, (st, _, five, _) in enumerate(levels):
        names = _NAMES[:5] if five else _NAMES
        want = [getattr(st, k).data_ptr() for k in names] + [0] * (9 - len(names))
        assert p1[11 * lvl:11 * lvl + 9] == want
        want3 = [getattr(new[lvl][0], k).data_ptr() for k in names] + [0] * (9 - len(names))
        assert p3[11 * lvl:11 * lvl + 9] == want3
        if 0 < lvl < first:
            assert 0 not in p1[11 * lvl + 9:11 * lvl + 11]
            assert p1[11 * lvl + 9:11 * lvl + 11] == p3[11 * lvl + 9:11 * lvl + 11]
        elif lvl >= first:
            assert p1[11 * lvl + 9:11 * lvl + 11] == [0, 0]
    p, r, cycles, rel = out1
    assert p1[9] == p.data_ptr() and p1[10] == b.data_ptr()
    assert p1[11 * L:] == [p0.data_ptr(), r.data_ptr(), cycles.data_ptr(),
                           cycles.data_ptr() + 4]
    assert rel.data_ptr() == cycles.data_ptr() + 4
    assert (cycles.dtype, rel.dtype, cycles.dim(), rel.dim()) == \
        (torch.int32, torch.float32, 0, 0)
    assert p2[9] == out2[0].data_ptr() != p1[9]  # a fresh output per call
    assert tuple(p.shape) == tuple(r.shape) == shapes[0]
    assert mg.SOLVE_LAUNCHES == 4


def test_k5_rejects_what_its_kernel_does_not_take(recorder):
    """A W-cycle, too many levels or a broken transfer pair raise before any
    launch."""
    p = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="V-cycles"):
        mg.fused_mg_solve(p, p, _levels([(64, 64), (32, 32)]), MultigridConfig(cycle_type="w"))
    with pytest.raises(ValueError, match="transfer pair"):
        mg.fused_mg_solve(p, p, _levels([(64, 64), (31, 31)]), MultigridConfig())
    with pytest.raises(ValueError, match="at most"):
        mg.fused_mg_solve(p, p, _levels([(64, 64)] * 17), MultigridConfig())
    assert recorder.calls == []


# ---------------------------------------------------------------------------
# K7


def _krylov_entry():
    """nf_bicgstab's text (to the end of the file) with ``kb_read``'s,
    which its band path reads its slots through."""
    src = _src("krylov.cu")
    return src[src.index("NF_EXPORT int nf_bicgstab("):] + _function(src, "void kb_read(")


def test_k7_constants_match_c_source():
    """The wrapper's band arrays, the grid kernel's scratch, the cluster's
    shared-memory sizing and the pointer and parameter slots against
    csrc/krylov.cu, coop.cuh and cluster.cuh."""
    band = _enum("KbArray", "krylov.cu")
    assert band[-1] == "KB_ARRAYS"
    to_name = {"AE": "a_e", "AW": "a_w", "AN": "a_n", "AS": "a_s", "AP": "a_p"}
    assert [to_name.get(e[3:], e[3:].lower()) for e in band[:-1]] == list(krylov.BAND_ARRAYS)
    src = _src("krylov.cu")
    assert "const int rows = (ni + size - 1) / size;" in src
    assert "return NF_CL_RED_FLOATS + (int64_t)KB_ARRAYS * (rows + 2) * nj;" in src
    entry = _krylov_entry()
    assert "float** vecs[] = {&K.r, &K.rhat, &K.v, &K.p, &K.s, &K.t};" in entry
    assert list(krylov.GRID_VECTORS) == ["r", "rhat", "v", "p", "s", "t"]
    assert "for (int k = 0; k < 6; ++k) *vecs[k] = scratch + k * n;" in entry
    assert "P.red = scratch + 6 * n;" in entry
    assert krylov.GRID_RED_FLOATS == 2 * _constant("NF_RED_SLOTS", "coop.cuh") * \
        _constant("NF_MAX_BLOCKS", "coop.cuh")
    assert "const float* x0 = reinterpret_cast<const float*>(ptrs[0]);" in entry
    assert "for (int k = 0; k < 6; ++k) coef[k] = reinterpret_cast<const float*>(ptrs[1 + k]);" \
        in entry
    assert "float* out = reinterpret_cast<float*>(ptrs[7]);" in entry
    assert "float* scratch = reinterpret_cast<float*>(ptrs[8]);" in entry
    assert "const int ni = ip[0], nj = ip[1];" in entry
    assert entry.count("P.maxiter = ip[2];") == 2
    assert "P.lo_i = ip[3]; P.hi_i = ip[4]; P.lo_j = ip[5]; P.hi_j = ip[6];" in entry
    assert "K.lo_i = ip[3]; K.hi_i = ip[4]; K.lo_j = ip[5]; K.hi_j = ip[6];" in entry
    assert "if (ip[7]) {" in entry and entry.count("P.tol = fp[0];") == 2
    assert "if (4 * floats > NF_CL_SMEM_MAX) return (int)cudaErrorInvalidValue;" in entry


def _band_rules():
    """csrc/krylov.cu's band start and owner, checked against the source
    and returned as Python functions."""
    src = _src("krylov.cu")
    assert "return (int)((int64_t)c * ni / size);" in src
    assert "return (int)(((int64_t)(i + 1) * size - 1) / ni);" in src
    return (lambda c, ni, size: c * ni // size,
            lambda i, ni, size: ((i + 1) * size - 1) // ni)


@pytest.mark.parametrize("ni", [5, 16, 63, 64, 255, 256, 511, 512])
@pytest.mark.parametrize("size", [16, 8])
def test_k7_bands_partition_the_rows(ni, size):
    """The CTAs' bands cover the rows in order, at most one row apart in
    height (some empty where there are fewer rows than CTAs), and the owner
    of each row is the CTA whose band holds it."""
    start, owner = _band_rules()
    bands = [(start(c, ni, size), start(c + 1, ni, size)) for c in range(size)]
    assert bands[0][0] == 0 and bands[-1][1] == ni
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    heights = [b - a for a, b in bands]
    assert max(heights) - min(heights) <= 1 and max(heights) == -(-ni // size)
    for i in range(ni):
        a, b = bands[owner(i, ni, size)]
        assert a <= i < b


@pytest.mark.parametrize("shape,size,rows,band", [
    ((64, 63), 16, 4, True), ((63, 64), 16, 4, True),
    ((64, 63), 8, 8, True), ((128, 127), 16, 8, True), ((127, 128), 16, 8, True),
    ((160, 159), 16, 10, False), ((256, 255), 16, 16, False), ((255, 256), 16, 16, False),
    ((512, 511), 16, 32, False), ((511, 512), 16, 32, False)])
def test_k7_band_layout(shape, size, rows, band):
    """K7's band height and kernel per shape: the headline's 64 x 63 / 63 x 64
    fields and up to 128 x 127 in the cluster's shared memory (23,704 bytes
    a CTA at 64 x 63 and 16 CTAs), 160 x 159, 255^2 and the largest fields
    the gate admits (1 MiB) on the cooperative grid, whose scratch holds
    its six vectors and the reduction partials; the gate admits every shape
    here."""
    assert krylov.supports_fused_bicgstab(shape, torch.float32)
    got_rows, got_band, smem = krylov.band_layout(shape, size)
    assert (got_rows, got_band) == (rows, band)
    need = 4 * (mg.CL_RED_FLOATS + len(krylov.BAND_ARRAYS) * (rows + 2) * shape[1])
    assert band == (need <= mg.SMEM_MAX)
    assert smem == (need if band else 0) <= mg.SMEM_MAX
    if (shape, size) == ((64, 63), 16):
        assert smem == 23_704
    assert krylov.grid_scratch_floats(shape) == 6 * shape[0] * shape[1] + 2 * 8 * 1024


def _coeffs(shape, seed):
    rng = np.random.default_rng(seed)
    return StencilCoeffs(**{k: torch.as_tensor(rng.random(shape), dtype=torch.float32)
                            for k in ("a_e", "a_w", "a_n", "a_s", "a_p", "src")})


def test_k7_wrapper_reuses_host_arrays_and_scratch(recorder):
    """Through a recording library: one pointer and parameter array per
    (shape, maxiter, margins, tol), x0, the six coefficients and the fresh
    output refilled per call; the band kernel with no scratch (slot 0), the
    grid kernel with one scratch tensor kept across calls; a new maxiter or
    shape a new state."""
    small, large = (64, 63), (256, 255)
    x0, c = torch.zeros(small), _coeffs(small, 1)
    out1 = krylov.bicgstab_momentum(x0, c, tol=1e-6, maxiter=20)
    c2 = _coeffs(small, 2)
    out2 = krylov.bicgstab_momentum(x0, c2, tol=1e-6, maxiter=20)
    krylov.bicgstab_momentum(x0, c, tol=1e-6, maxiter=3)
    xl, cl = torch.zeros(large), _coeffs(large, 3)
    krylov.bicgstab_momentum(xl, cl, tol=1e-6, maxiter=20, margins=(1, 1, 2, 1))
    krylov.bicgstab_momentum(xl, cl, tol=1e-6, maxiter=20, margins=(1, 1, 2, 1))
    (e1, p1, ip1, fp1, s1, a1, i1), (_, p2, ip2, _, _, a2, i2), (_, _, ip3, _, _, a3, _), \
        (_, p4, ip4, _, _, a4, _), (_, p5, _, _, _, a5, _) = recorder.calls
    assert e1 == "nf_bicgstab" and s1 == 7 and fp1 == pytest.approx([1e-6])
    assert a1 is a2 and i1 is i2 and a3 is not a1 and a4 is a5 and a4 is not a1
    assert ip1 == ip2 == [64, 63, 20, 1, 1, 1, 1, 1] and ip3[2] == 3
    assert ip4 == [256, 255, 20, 1, 1, 2, 1, 0]
    assert p1[:8] == [t.data_ptr() for t in (x0, c.a_e, c.a_w, c.a_n, c.a_s, c.a_p, c.src,
                                              out1)]
    assert p2[1:7] == [t.data_ptr() for t in (c2.a_e, c2.a_w, c2.a_n, c2.a_s, c2.a_p, c2.src)]
    assert p2[7] == out2.data_ptr() != p1[7] and p1[8] == 0
    st = krylov._LAUNCH[(torch.device("cpu"), 7, large, 20, (1, 1, 2, 1), 1e-6)]
    assert p4[8] == p5[8] == st.scratch.data_ptr() != 0
    assert st.scratch.numel() == krylov.grid_scratch_floats(large)
    assert krylov.LAUNCHES == 5


# ---------------------------------------------------------------------------
# the CPU path


def test_cpu_tensors_run_the_plain_versions_and_match_jax(monkeypatch):
    """CPU tensors still run K5's and K7's plain versions (no launch) and
    agree with the JAX package's Pallas kernels in interpret mode: K5 on a
    seeded 15^2 vertex hierarchy at 1e-4 / 30 cycles (equal cycle counts,
    p within 1e-4 of scale, rel within 1e-5) and K7 on the u system of a
    noisy 24^2 cavity state with a wider low-j margin, maxiter 25 (1e-4 of
    the field); tests/test_pallas.py's tolerances."""
    calls = {"K5": 0, "K7": 0}
    for module, name, key in ((mg, "fused_mg_solve_plain", "K5"),
                              (krylov, "bicgstab_momentum_plain", "K7")):
        real = getattr(module, name)

        def wrapped(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)
    launches = (mg.SOLVE_LAUNCHES, krylov.LAUNCHES)

    nx = 15
    rng = np.random.default_rng(17)
    d_u = jnp.asarray((rng.random((nx + 1, nx)) + 0.5).astype(np.float32))
    d_v = jnp.asarray((rng.random((nx, nx + 1)) + 0.5).astype(np.float32))
    b = rng.normal(size=(nx, nx)).astype(np.float32)
    b = jnp.asarray(b - b.mean())
    jcfg = JMG(tolerance=1e-4, max_cycles=30, check_every=2, coarsest_sweeps=16,
               coarsest_grid_size=3)
    jlev = j_build_levels(d_u, d_v, jcfg, dx=1 / (nx - 1), dy=1 / (nx - 1), rho=1.0,
                          variant="consistent")
    tcfg = interop.config(jcfg)
    tlev = t_build_levels(torch.tensor(np.asarray(d_u)), torch.tensor(np.asarray(d_v)),
                          tcfg, dx=1 / (nx - 1), dy=1 / (nx - 1), rho=1.0,
                          variant="consistent")
    assert [shp for _, shp, _, _ in tlev] == [(15, 15), (7, 7), (3, 3)]
    wp, _, wcyc, wrel = j_mg_solve(jnp.zeros((nx, nx), jnp.float32), b, jlev, jcfg,
                                   interpret=True)
    gp, _, gcyc, grel = mg.fused_mg_solve(torch.zeros(nx, nx),
                                          torch.tensor(np.asarray(b)), tlev, tcfg)
    assert int(gcyc) == int(wcyc)
    assert np.max(np.abs(gp.numpy() - np.asarray(wp))) / np.max(np.abs(np.asarray(wp))) < 1e-4
    assert abs(float(grel) - float(wrel)) < 1e-5

    m = 24
    mesh = nf.StructuredMesh(nx=m, ny=m)
    bc = nf.lid_driven_cavity(1.0)
    st = nf.initialize_state(mesh, bc, dtype=jnp.float32)
    u = jnp.asarray(st.u + 0.05 * rng.normal(size=st.u.shape), jnp.float32)
    v = jnp.asarray(st.v + 0.05 * rng.normal(size=st.v.shape), jnp.float32)
    p = jnp.asarray(rng.normal(size=st.p.shape), jnp.float32)
    kw = dict(dx=1.0 / (m - 1), dy=1.0 / (m - 1), rho=1.0, mu=0.01)
    c = relax_coefficients(u_momentum_coefficients(u, v, p, **kw), u, 0.7)
    margins = (1, 1, 2, 1)
    want = np.asarray(j_bicgstab(u, c, tol=1e-8, maxiter=25, margins=margins,
                                 interpret=True))
    got = krylov.bicgstab_momentum(torch.tensor(np.asarray(u)),
                                   interop.stencil_coeffs(c, dtype=torch.float32),
                                   tol=1e-8, maxiter=25, margins=margins).numpy()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-4
    assert calls == {"K5": 1, "K7": 1}
    assert (mg.SOLVE_LAUNCHES, krylov.LAUNCHES) == launches
