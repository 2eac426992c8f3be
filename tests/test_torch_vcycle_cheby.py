"""The V-cycle kernel K3 and the Chebyshev strip kernel K9 of the PyTorch
port, on the CPU: their launch plumbing held against the C entries
(``csrc/mg.cu`` / ``csrc/vcycle.cuh``, ``csrc/cheby.cu``, parsed from the
source); the shared-memory sizing of both K3 hierarchies and of K9's tile;
the wrappers' reuse of their host arrays and scratch across calls (through
a library that records its calls); the decoding of K3's phase timers; and
the guard that CPU tensors still run the plain versions and agree with the
JAX package's Pallas kernels in interpret mode.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naviflow_tpu.ops.pallas_cheby import chebyshev_momentum_strips as j_cheby
from naviflow_tpu.ops.pallas_mg import fused_vcycle as j_vcycle
from naviflow_tpu.ops.powerlaw import relax_coefficients
from naviflow_tpu.ops.stencil9 import Stencil9 as JStencil9
from naviflow_tpu.solvers.momentum import _assemble_coeffs, _chebyshev_bounds, _u_interior_mask
from naviflow_tpu.solvers.multigrid import MultigridConfig as JMultigridConfig

import naviflow_tpu as nf
from naviflow_tpu.core.bc import apply_velocity_bcs
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops import _cuda, cheby, mg
from naviflow_tpu_torch.ops.stencil import StencilCoeffs
from naviflow_tpu_torch.ops.stencil9 import Stencil9
from naviflow_tpu_torch.solvers.multigrid import MultigridConfig

torch.set_num_threads(2)

CSRC = Path(mg.__file__).resolve().parent.parent / "csrc"
TAIL = [(256, 256), (128, 128), (64, 64), (32, 32), (16, 16), (8, 8), (4, 4)]
VERTEX = [(63, 63), (31, 31), (15, 15), (7, 7)]
# the H100's shared memory a block may use (232,448 bytes)
BLOCK_SMEM = 227 * 1024


def _src(name):
    return (CSRC / name).read_text()


def _constant(name, path):
    return int(re.search(rf"constexpr int {name} = (\d+);", _src(path)).group(1))


def _enum(name, path):
    body = re.search(rf"enum {name} \{{([^}}]*)\}}", _src(path)).group(1)
    return [e.split("=")[0].strip() for e in body.split(",") if e.strip()]


def _levels(shapes, seed=0):
    """A hierarchy of seeded random stencils (5-point level 0, 9-point below)."""
    rng = np.random.default_rng(seed)
    out = []
    for lvl, shp in enumerate(shapes):
        arrays = {k: torch.as_tensor(rng.normal(size=shp), dtype=torch.float32)
                  for k in ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")}
        if lvl == 0:
            for k in ("ne", "nw", "se", "sw"):
                arrays[k] = torch.zeros(shp)
        out.append((Stencil9(**arrays), shp, lvl == 0, None))
    return out


class _Recorder:
    """Records the K3 and K9 C entries' pointer, int and float arrays."""

    def __init__(self):
        self.calls = []

    def _record(self, name, ptrs, ip, fp, stream):
        self.calls.append((name, list(ptrs), list(ip), list(fp), stream, ptrs, ip))
        return 0

    def nf_fused_vcycle(self, *a):
        return self._record("nf_fused_vcycle", *a)

    def nf_fused_vcycle_phases(self, *a):
        return self._record("nf_fused_vcycle_phases", *a)

    def nf_chebyshev_strips(self, *a):
        return self._record("nf_chebyshev_strips", *a)


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "require_all", lambda *a: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda x: 7)
    # the launch state and counters of the fake launches stay in this test
    monkeypatch.setattr(mg, "_VC", {})
    monkeypatch.setattr(cheby, "_IP", {})
    monkeypatch.setattr(mg, "LAUNCHES", mg.LAUNCHES)
    monkeypatch.setattr(cheby, "LAUNCHES", cheby.LAUNCHES)
    return lib


# ---------------------------------------------------------------------------
# K3


def test_k3_constants_match_c_source():
    """The wrapper's integer-parameter names, small-level rule, shared-memory
    cap and register-level slots against csrc/vcycle.cuh, coop.cuh and
    cluster.cuh; the C entry reads the input iterate and the timers right
    after the 11 level pointers."""
    ip_enum = _enum("NfVcIp", "vcycle.cuh")
    assert ip_enum[-1] == "VC_IP_LEVELS" and len(ip_enum) - 1 == len(mg.VC_IP)
    assert [e.removeprefix("VC_IP_").lower() for e in ip_enum[:-1]] == \
        ["l", "pre", "post", "coarsest", "ls"]
    assert mg.SMALL_CELLS == _constant("NF_SMALL_CELLS", "coop.cuh")
    cap = re.search(r"constexpr int NF_CL_SMEM_MAX = (\d+) \* 1024;", _src("cluster.cuh"))
    assert mg.SMEM_MAX == int(cap.group(1)) * 1024
    entry = _src("mg.cu")
    entry = entry[entry.index("int launch_vcycle("):entry.index("NF_EXPORT int nf_fused_vcycle(")]
    assert "P.p_in = reinterpret_cast<const float*>(ptrs[11 * L]);" in entry
    assert "ptrs[11 * L + 1]" in entry
    assert "read_levels(P.M, ptrs, ip + VC_IP_LEVELS, L)" in entry
    smem = re.search(r"nf_vc_smem_floats\(const int\* cells, int L, int Ls\) \{(.*?)\n\}",
                     _src("vcycle.cuh"), re.S).group(1)
    assert "int64_t n = cells[Ls];" in smem and "n += 11 * (int64_t)cells[l];" in smem


@pytest.mark.parametrize("shapes,first", [(TAIL, 3), (VERTEX, 1), (TAIL[:3], 3),
                                          ([(64, 64), (32, 32)], 1), ([(31, 31)], 1)])
def test_k3_shared_memory_sizing(shapes, first):
    """The levels in rank 0's shared memory and their bytes: the 256^2 tail
    keeps 32^2 -> 4^2 there, the 63^2 vertex hierarchy 31^2 -> 7^2, both
    within the cluster launch's cap and the H100's 227 KB a block."""
    got_first, nbytes = mg.vcycle_layout(shapes)
    assert got_first == min(first, len(shapes))
    cells = [a * b for a, b in shapes]
    want = 0 if got_first == len(shapes) else \
        4 * (cells[got_first] + 11 * sum(cells[got_first:]))
    assert nbytes == want
    assert nbytes <= mg.SMEM_MAX < BLOCK_SMEM
    if shapes is TAIL:
        assert nbytes == 4 * (1024 + 11 * 1360)  # 63,936 bytes
    if shapes is VERTEX:
        assert nbytes == 4 * (961 + 11 * 1235)


@pytest.mark.parametrize("shapes", [TAIL[:5], VERTEX], ids=["cell_centred", "vertex"])
def test_k3_launch_layout_and_scratch_reuse(recorder, shapes):
    """Through a recording library: per level 9 stencil pointers (0 for the
    five-point level's corners), then x and rhs (level 0: the fresh output
    and b; the levels in global memory: scratch kept across calls; the
    shared-memory levels: 0), then the input iterate; the integer layout of
    NfVcIp; the host arrays and scratch reused for a second call and the
    stencil slots refilled for a new hierarchy of the same shapes."""
    cfg = MultigridConfig(pre_smoothing=1, post_smoothing=2, coarsest_sweeps=5, omega=1.1)
    levels = _levels(shapes)
    n0 = shapes[0]
    p, b = torch.zeros(n0), torch.ones(n0)
    out1 = mg._vc_launch(p, b, levels, cfg)
    out2 = mg._vc_launch(p, b, levels, cfg)
    new = _levels(shapes, seed=1)
    mg._vc_launch(p, b, new, cfg)
    (e1, p1, ip1, fp1, s1, a1, i1), (_, p2, ip2, _, _, a2, i2), (_, p3, _, _, _, a3, _) = \
        recorder.calls
    L = len(shapes)
    first, _ = mg.vcycle_layout(shapes)
    assert e1 == "nf_fused_vcycle" and s1 == 7 and fp1 == pytest.approx([1.1])
    assert a1 is a2 is a3 and i1 is i2  # the same host arrays
    assert len(p1) == 11 * L + 1 and ip1 == ip2
    assert ip1[:5] == [L, 1, 2, 5, first]
    assert ip1[5:] == [m for lvl, shp in enumerate(shapes) for m in (*shp, int(lvl == 0))]
    for lvl, (st, _, five, _) in enumerate(levels):
        names = ("c", "e", "w", "n", "s") if five else \
            ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")
        want = [getattr(st, k).data_ptr() for k in names] + [0] * (9 - len(names))
        assert p1[11 * lvl:11 * lvl + 9] == want
        want3 = [getattr(new[lvl][0], k).data_ptr() for k in names] + [0] * (9 - len(names))
        assert p3[11 * lvl:11 * lvl + 9] == want3
        if 0 < lvl < first:  # scratch x and rhs, the same in every call
            assert p1[11 * lvl + 9] != 0 and p1[11 * lvl + 10] != 0
            assert p1[11 * lvl + 9:11 * lvl + 11] == p3[11 * lvl + 9:11 * lvl + 11]
        elif lvl >= first:
            assert p1[11 * lvl + 9:11 * lvl + 11] == [0, 0]
    assert p1[9] == out1.data_ptr() and p2[9] == out2.data_ptr()
    assert p1[10] == b.data_ptr() and p1[11 * L] == p.data_ptr()
    assert tuple(out1.shape) == n0


def test_k3_timed_launch_appends_the_timer_buffer(recorder):
    """The timed instantiation gets the same layout plus the timer buffer's
    address, through its own host arrays."""
    cfg = MultigridConfig()
    levels = _levels(TAIL[2:])
    p, b = torch.zeros(64, 64), torch.ones(64, 64)
    mg._vc_launch(p, b, levels, cfg)
    timers = torch.zeros(mg.N_VC_TIMERS, dtype=torch.int64)
    mg._vc_launch(p, b, levels, cfg, timers)
    (e1, p1, ip1, *_), (e2, p2, ip2, *_) = recorder.calls
    assert (e1, e2) == ("nf_fused_vcycle", "nf_fused_vcycle_phases")
    assert ip1 == ip2 and len(p2) == len(p1) + 1 and p2[-1] == timers.data_ptr()
    assert p2[:9] == p1[:9] and p2[10:len(p1)] == p1[10:]  # all but the output


def test_k3_phase_buffer_decoding():
    """``decode_vcycle_phases`` on synthetic stamps: per phase the summed ns,
    then the counts, then the last stamp (csrc/vcycle.cuh NfVcPhase)."""
    enum = _enum("NfVcPhase", "vcycle.cuh")
    assert [e.removeprefix("VC_").lower() for e in enum[:-1]] == list(mg.VC_PHASE_NAMES)
    assert enum[-1] == "NF_VC_PHASES"
    assert mg.N_VC_TIMERS == 2 * len(mg.VC_PHASE_NAMES) + 1
    ns = [125_000, 2_500_000, 40_000, 1_000]
    got = mg.decode_vcycle_phases(torch.tensor(ns + [3, 6, 1, 3, 987_654_321]))
    assert got == {"down": (0.125, 3), "small": (2.5, 6), "coarsest": (0.04, 1),
                   "up": (0.001, 3)}
    with pytest.raises(ValueError):
        mg.decode_vcycle_phases([0] * 8)


def test_k3_rejects_what_its_kernel_does_not_take(recorder):
    """Too many levels, a broken transfer pair, a W-cycle or a Jacobi
    smoother raise before any launch."""
    cfg = MultigridConfig()
    p = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="transfer pair"):
        mg._vc_launch(p, p, _levels([(64, 64), (31, 31)]), cfg)
    with pytest.raises(ValueError, match="at most"):
        mg._vc_launch(p, p, _levels([(64, 64)] * 17), cfg)
    assert recorder.calls == []


# ---------------------------------------------------------------------------
# K9


def _cheby_entry():
    """The C entry's slot reader (``read_cheby``, which the single entry and
    the batched one call), after checking the single entry calls it."""
    src = _src("cheby.cu")
    entry = src[src.index("NF_EXPORT int nf_chebyshev_strips("):]
    assert "read_cheby(ptrs, ip, P);" in entry[:entry.index("\n}\n")]
    return src[src.index("void read_cheby("):]


def test_k9_slots_match_c_entry():
    """The wrapper's pointer slots against the C entry's reads: the inputs
    and the interval scalars through ``ins[]``, then x* and r."""
    entry = _cheby_entry()
    ins = re.search(r"const float\*\* ins\[\] = \{([^}]*)\}", entry).group(1)
    fields = [f.strip().removeprefix("&P.") for f in ins.split(",")]
    c_to_slot = {"x0": "x0", "ae": "a_e", "aw": "a_w", "an": "a_n", "as": "a_s", "ap": "a_p",
                 "src": "src", "ap_un": "a_p_un", "src_un": "src_un", "theta": "theta",
                 "delta": "delta", "sigma1": "sigma1"}
    assert [c_to_slot[f] for f in fields] == list(cheby.SLOTS[:len(fields)])
    assert f"for (int k = 0; k < {len(fields)}; ++k)" in entry
    assert f"P.x_out = reinterpret_cast<float*>(ptrs[{len(fields)}]);" in entry
    assert f"P.r_out = reinterpret_cast<float*>(ptrs[{len(fields) + 1}]);" in entry
    assert cheby.SLOTS[len(fields):] == ("x_star", "r")


@pytest.mark.parametrize("degree", range(1, cheby.H))
def test_k9_tile_and_shared_memory(degree):
    """csrc/cheby.cu's tile and shared memory at every degree the wrapper
    admits: a tile of >= 16 x 32 owned faces; the stage and the iterate
    buffers within the H100's 227 KB a block, and two blocks an SM (228 KB)
    up to degree 7, where the kernel asks for two."""
    src = _src("cheby.cu")
    threads, cpl, staged = (_constant(k, "cheby.cu") for k in ("THREADS", "CPL", "STAGED"))
    assert "constexpr int PJ = RJ + 2;" in src and "constexpr int RJ = 32 * CPL;" in src
    rule = re.search(r"rows_per_warp\(int degree\) \{ return degree <= (\d+) \? (\d+) : (\d+);",
                     src)
    two = degree <= int(rule.group(1))
    assert "__launch_bounds__(THREADS, DEG <= %s ? 2 : 1)" % rule.group(1) in src
    ri = threads // 32 * int(rule.group(2) if two else rule.group(3))
    rj = 32 * cpl
    assert "return region_i(degree) - 2 * (degree + 1);" in src
    assert "return RJ - 2 * (degree + 1);" in src
    assert ri - 2 * (degree + 1) >= 16 and rj - 2 * (degree + 1) >= 32
    smem = re.search(r"smem_floats\(int degree\) \{\s*return (.*?);", src, re.S).group(1)
    assert " ".join(smem.split()) == \
        "STAGED * region_i(degree) * RJ + 2 * (region_i(degree) + 2) * PJ"
    nbytes = 4 * (staged * ri * rj + 2 * (ri + 2) * (rj + 2))
    assert nbytes <= BLOCK_SMEM
    if two:
        assert 2 * nbytes <= 228 * 1024


def _coeffs(shape, seed):
    rng = np.random.default_rng(seed)
    return StencilCoeffs(**{k: torch.as_tensor(rng.random(shape), dtype=torch.float32)
                            for k in ("a_e", "a_w", "a_n", "a_s", "a_p", "src")})


def test_k9_wrapper_reuses_host_arrays(recorder, monkeypatch):
    """Through a recording library: one pointer array for every call, the
    slots in SLOTS' order; the integer parameters cached per shape and
    degree; the solver's 0-d float32 scalars passed by address, Python
    floats stacked into a fresh tensor."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    shape = (9, 8)
    x0 = torch.zeros(shape)
    c_rel, c_un = _coeffs(shape, 1), _coeffs(shape, 2)
    th, de, si = (torch.tensor(v, dtype=torch.float32) for v in (1.0, 0.5, 2.0))
    x1, r1 = cheby.chebyshev_momentum_strips(x0, c_rel, c_un, theta=th, delta=de, sigma1=si,
                                             degree=4)
    cheby.chebyshev_momentum_strips(x0, c_rel, c_un, theta=1.0, delta=0.5, sigma1=2.0,
                                    degree=4)
    (e1, p1, ip1, _, s1, a1, i1), (_, p2, ip2, _, _, a2, i2) = recorder.calls
    assert e1 == "nf_chebyshev_strips" and s1 == 7 and a1 is a2 and i1 is i2
    assert ip1 == ip2 == [9, 8, 4] and len(p1) == len(cheby.SLOTS)
    arrays = [x0, c_rel.a_e, c_rel.a_w, c_rel.a_n, c_rel.a_s, c_rel.a_p, c_rel.src,
              c_un.a_p, c_un.src]
    assert p1[:9] == [a.data_ptr() for a in arrays]
    assert p1[9:12] == [th.data_ptr(), de.data_ptr(), si.data_ptr()]
    assert p1[12:] == [x1.data_ptr(), r1.data_ptr()]
    assert p2[9:12] != p1[9:12] and p2[10] - p2[9] == p2[11] - p2[10] == 4
    with pytest.raises(ValueError, match="degree"):
        cheby.chebyshev_momentum_strips(x0, c_rel, c_un, theta=th, delta=de, sigma1=si,
                                        degree=cheby.H)
    assert len(recorder.calls) == 2


# ---------------------------------------------------------------------------
# the CPU path


def _to_jax(st):
    return JStencil9(**{k: jnp.asarray(getattr(st, k).numpy()) for k in
                        ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")})


def test_cpu_tensors_run_the_plain_versions_and_match_jax(monkeypatch):
    """CPU tensors still run K3's and K9's plain versions (no launch) and
    agree with the JAX package's Pallas kernels in interpret mode: one
    V-cycle on a seeded cell-centred 64^2 -> 4^2 hierarchy (1e-5 of the
    output's scale) and the u-field Chebyshev solve at 48^2, degree 4 (rtol /
    atol 2e-5)."""
    from naviflow_tpu_torch.solvers.multigrid import build_levels

    calls = {"K3": 0, "K9": 0}
    for module, name, key in ((mg, "fused_vcycle_plain", "K3"),
                              (cheby, "chebyshev_momentum_strips_plain", "K9")):
        real = getattr(module, name)

        def wrapped(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)
    launches = (mg.LAUNCHES, cheby.LAUNCHES)

    n = 64
    rng = np.random.default_rng(21)
    d_u = torch.as_tensor(rng.random((n + 1, n)) + 0.5, dtype=torch.float32)
    d_v = torch.as_tensor(rng.random((n, n + 1)) + 0.5, dtype=torch.float32)
    b = rng.normal(size=(n, n)).astype(np.float32)
    tcfg = MultigridConfig(coarsest_sweeps=32, pre_smoothing=1, post_smoothing=1)
    jcfg = JMultigridConfig(coarsest_sweeps=32, pre_smoothing=1, post_smoothing=1)
    tlev = build_levels(d_u, d_v, tcfg, dx=1.0 / n, dy=1.0 / n, rho=1.0, variant="consistent")
    assert [shp[0] for _, shp, _, _ in tlev] == [64, 32, 16, 8, 4]
    jlev = [(_to_jax(st), shp, five, None) for st, shp, five, _ in tlev]
    want = np.asarray(j_vcycle(jnp.zeros((n, n), jnp.float32), jnp.asarray(b), jlev, jcfg,
                               interpret=True))
    got = mg.fused_vcycle(torch.zeros(n, n), torch.as_tensor(b), tlev, tcfg).numpy()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5

    m = 48
    mesh = nf.StructuredMesh(nx=m, ny=m)
    bc = nf.lid_driven_cavity(1.0)
    st = nf.initialize_state(mesh, bc, dtype=jnp.float32)
    u = jnp.asarray(st.u + 0.1 * rng.normal(size=st.u.shape), jnp.float32)
    v = jnp.asarray(st.v + 0.1 * rng.normal(size=st.v.shape), jnp.float32)
    p = jnp.asarray(rng.normal(size=st.p.shape), jnp.float32)
    u, v = apply_velocity_bcs(u, v, bc)
    kw = dict(dx=1.0 / (m - 1), dy=1.0 / (m - 1), rho=1.0, mu=0.01)
    c_un = _assemble_coeffs(u, v, p, scheme="power_law", is_u=True, **kw)
    c_rel = relax_coefficients(c_un, u, 0.7)
    theta, delta, sigma1 = _chebyshev_bounds(c_rel, _u_interior_mask(u.shape))
    want_x, want_r = j_cheby(u, c_rel, c_un, theta=theta, delta=delta, sigma1=sigma1,
                             degree=4, interpret=True)
    T = interop.tensor
    got_x, got_r = cheby.chebyshev_momentum_strips(
        T(u, dtype=torch.float32), interop.stencil_coeffs(c_rel, dtype=torch.float32),
        interop.stencil_coeffs(c_un, dtype=torch.float32), theta=T(theta, dtype=torch.float32),
        delta=T(delta, dtype=torch.float32), sigma1=T(sigma1, dtype=torch.float32), degree=4)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=2e-5, atol=2e-5)
    assert calls == {"K3": 1, "K9": 1}
    assert (mg.LAUNCHES, cheby.LAUNCHES) == launches
