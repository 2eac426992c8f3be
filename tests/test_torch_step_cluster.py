"""The whole-step kernel K6's launch plumbing and K11b's lean call, on the
CPU: the pointer / int / float layout the K6 wrapper builds, held against
the order the C entry (``csrc/step.cuh``) reads it for every body and 1-5
levels; the wrapper's reuse of its scratch across calls (through a library
that records its calls); the decoding of the phase-timer buffer; and the
guard that CPU tensors still run the plain versions of K6 and K11b and
agree with the JAX package there.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig
from naviflow_tpu.algorithms.simple import make_simple_step
from naviflow_tpu.ops.pallas_kernels import apply_poisson_pallas
from naviflow_tpu.ops.poisson import poisson_coefficients as j_poisson
from naviflow_tpu.solvers import KrylovMomentumConfig
from naviflow_tpu.solvers.multigrid import MultigridConfig

from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import PISOConfig, SIMPLECConfig, SIMPLERConfig
from naviflow_tpu_torch.algorithms import SIMPLEConfig as TSIMPLEConfig
from naviflow_tpu_torch.core.bc import lid_driven_cavity
from naviflow_tpu_torch.ops import _cuda, kernels, step
from naviflow_tpu_torch.ops.poisson import poisson_coefficients

torch.set_num_threads(2)

CSRC = Path(step.__file__).resolve().parent.parent / "csrc"
MOM = KrylovMomentumConfig(tolerance=1e-6, max_iterations=20)
PRES = MultigridConfig(tolerance=1e-2, max_cycles=6, cycle_type="v", check_every=2,
                       coarsest_sweeps=8, coarse_rebuild_every=8)
BODIES = {"simple": TSIMPLEConfig(), "simplec": SIMPLECConfig(smooth_p_prime=True),
          "piso": PISOConfig(corrector="exact", n_corrections=3), "simpler": SIMPLERConfig()}


def _c_pointer_reads():
    """The pointer reads of ``launch_step`` in csrc/step.cuh, in order: the
    fixed ones as (target, count), and the reads of one coarse level held
    in global memory."""
    src = (CSRC / "step.cuh").read_text()
    start = src.index("int launch_step(")
    body = src[start:src.index("}  // namespace", start)]
    head, levels = body.split("for (int l = 0; l < L; ++l)", 1)
    stmt = re.compile(r"(?:for \(int a = 0; a < (\d+); \+\+a\) )?([\w.\[\]>-]+) = "
                      r"(?:reinterpret_cast<[^>]+>\()?next\(\)")
    fixed = [(target, int(n or 1)) for n, target in stmt.findall(head)]
    big = levels[levels.index("cells > NF_SMALL_CELLS"):levels.index("} else {")]
    per_level = sum(int(n or 1) for n, _ in stmt.findall(big))
    return fixed, per_level


# C target -> the wrapper's slot name (without an index)
C_TO_SLOT = {"P.u_in": "u", "P.v_in": "v", "P.A.p": "p", "P.sc_in": "scalars_in",
             "P.u_out": "u_out", "P.v_out": "v_out", "P.p_out": "p_out", "P.r_u": "r_u",
             "P.r_v": "r_v", "P.r_p": "r_p", "P.sc_out": "scalars_out", "P.cyc_out": "cycles",
             "P.ub": "ub", "P.vb": "vb", "P.cu[a]": "cu", "P.cv[a]": "cv", "P.ustar": "u_star",
             "P.vstar": "v_star", "P.d_u": "d_u", "P.d_v": "d_v", "P.kry": "krylov",
             "P.pnew": "p_before_bcs", "P.psm": "p_prime_smoothed", "P.fine[a]": "fine_",
             "b": "b", "pprime": "p_prime"}


def _constant(path, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / path).read_text()).group(1))


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("algo", ["simple", "simplec", "piso", "simpler"])
def test_k6_launch_layout_matches_c_entry(algo, levels):
    """``launch_slots`` / ``launch_params`` against the reads of the C
    entry (csrc/step.cuh), for each body and 1-5 levels, at 63^2 (every
    coarse level small enough for shared memory: no slots) and at 255^2
    (the 127^2 and 63^2 levels in global memory: 11 slots each)."""
    assert step.SMALL_CELLS == _constant("coop.cuh", "NF_SMALL_CELLS")
    fixed, per_level = _c_pointer_reads()
    assert per_level == 11
    for n in (63, 255):
        coarsest = {1: n, 2: (n - 1) // 2, 3: (n - 3) // 4, 4: (n - 7) // 8,
                    5: (n - 15) // 16}[levels]
        pres = dataclasses.replace(interop.config(PRES), coarsest_grid_size=coarsest)
        shapes = step.step_shapes(n, n, pres)
        assert len(shapes) == levels
        for timers in (False, True):
            slots = step.launch_slots(algo, n, n, shapes, timers)
            names = [name for name, _, _ in slots]
            k = 0
            for target, count in fixed:
                want = C_TO_SLOT[target]
                for _ in range(count):
                    ok = names[k].startswith(want) if count > 1 else names[k] == want
                    assert ok, (target, names[k])
                    k += 1
            assert k == step.N_IO + 32  # the inputs, outputs and fine-level scratch
            big = [shp for shp in shapes[1:] if shp[0] * shp[1] > step.SMALL_CELLS]
            assert len(slots) == k + per_level * len(big) + timers
            assert all(shape == big[j // 11] for j, (_, shape, _) in
                       enumerate(slots[k:k + per_level * len(big)]))
            if timers:
                assert slots[-1] == ("timers", (step.N_TIMERS,), torch.int64)
        n_in, n_out = step.ALGO_SCALARS[algo]
        assert [s[1] for s in slots[:12]] == [(n + 1, n), (n, n + 1), (n, n), (n_in,),
                                            (n + 1, n), (n, n + 1), (n, n), (n + 1, n),
                                            (n, n + 1), (n, n), (n_out,), (1,)]
        cfg = BODIES[algo]
        mesh_kw = dict(dx=1.0 / n, dy=1.0 / n, rho=1.0, mu=0.01, bc=lid_driven_cavity(1.0),
                       cfg=cfg, mom_cfg=interop.config(MOM), pres_cfg=pres)
        ip, fp = step.launch_params(algo, n, n, shapes, **mesh_kw)
        assert len(ip) == 22 + 2 * levels and len(fp) == 21
        assert ip[:4] == [["simple", "simplec", "piso", "simpler"].index(algo), n, n, levels]
        assert ip[13:18] == [getattr(cfg, "n_corrections", 0),
                             int(getattr(cfg, "corrector", "") == "exact"),
                             getattr(cfg, "corrector_sweeps", 0),
                             int(getattr(cfg, "smooth_p_prime", False)),
                             int(getattr(cfg, "dynamic_alpha_p", False))]
        assert ip[18:22] == [1, 0, 0, 0]  # the lid is the one velocity side
        assert ip[22:] == [m for shp in shapes for m in shp]
        assert fp[6:8] == [cfg.alpha_u, 1.0 - cfg.alpha_u] and fp[13] == 1.0


def test_phase_buffer_decoding():
    """``decode_phases`` on synthetic stamps: per phase the summed ns, then
    the counts, then the last stamp (csrc/cluster.cuh NfPhase)."""
    enum = re.search(r"enum NfPhase \{([^}]*)\}", (CSRC / "cluster.cuh").read_text()).group(1)
    assert len([e for e in enum.split(",") if e.strip()]) == len(step.PHASE_NAMES) + 1
    n = len(step.PHASE_NAMES)
    ns = [250_000 * (k + 1) for k in range(n)]
    counts = [k % 3 + 1 for k in range(n)]
    got = step.decode_phases(torch.tensor(ns + counts + [123_456_789], dtype=torch.int64))
    assert list(got) == list(step.PHASE_NAMES)
    for k, name in enumerate(step.PHASE_NAMES):
        assert got[name] == (0.25 * (k + 1), counts[k])
    with pytest.raises(ValueError):
        step.decode_phases([0] * (2 * n))


class _Recorder:
    """Records the K6 C entry's pointer, int and float arrays."""

    def __init__(self):
        self.calls = []

    def nf_fused_outer_step(self, ptrs, ip, fp, stream):
        self.calls.append((list(ptrs), list(ip), list(fp), stream))
        return 0


def test_k6_wrapper_reuses_scratch(monkeypatch):
    """Through a library that records its calls: two steps of one
    configuration pass the same scratch pointers and fresh outputs laid
    out back to back, the inputs' addresses in the first slots, and the
    scalar carry of the first step's results by address."""
    lib = _Recorder()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "require", lambda *a: None)
    monkeypatch.setattr(_cuda, "stream_of", lambda x: 7)
    step._SCRATCH.clear()
    n = 31
    pres = interop.config(PRES)
    kw = dict(dx=1.0 / n, dy=1.0 / n, rho=1.0, mu=0.01, bc=lid_driven_cavity(1.0),
              cfg=BODIES["simplec"], mom_cfg=interop.config(MOM), pres_cfg=pres)
    u, v, p = torch.zeros(n + 1, n), torch.zeros(n, n + 1), torch.zeros(n, n)
    out1 = step._launch("simplec", u, v, p, (0.5, float("inf")), None, **kw)
    out2 = step._launch("simplec", u, v, p, out1[3][:2], None, **kw)
    (p1, ip1, fp1, s1), (p2, ip2, fp2, s2) = lib.calls
    assert s1 == s2 == 7 and ip1 == ip2 and fp1 == fp2
    slots = step.launch_slots("simplec", n, n, step.step_shapes(n, n, pres))
    assert len(p1) == len(slots) and p1[step.N_IO:] == p2[step.N_IO:]
    assert p1[:3] == [u.data_ptr(), v.data_ptr(), p.data_ptr()]
    assert p2[3] == out1[3][0].data_ptr()  # the carry by address, no copy
    sizes = [int(np.prod(shape)) for _, shape, _ in slots[4:step.N_IO]]
    assert [b - a for a, b in zip(p2[4:step.N_IO - 1], p2[5:step.N_IO])] == \
        [4 * s for s in sizes[:-1]]
    assert p1[4] != p2[4]  # fresh outputs a call
    assert tuple(out2[0].shape) == (n + 1, n) and out2[4].dtype == torch.int32
    assert len(out2[3]) == 5


def test_require_all_raises_on_a_failing_tensor():
    """The lean argument check still raises, with the reason, on a tensor
    the kernel does not take."""
    a = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.require_all([a, a], (4, 4), "input")


def test_cpu_tensors_run_the_plain_versions_and_match_jax(monkeypatch):
    """CPU tensors still run K6's and K11b's plain versions (no launch) and
    agree with the JAX package on seeded numpy inputs at the existing
    tolerances: one SIMPLE step from a seeded noisy 31^2 cavity state (u, v,
    p within 2e-4, equal cycle counts) and the matvec on a seeded system
    (rtol / atol 1e-6 against the Pallas kernel in interpret mode)."""
    calls = {"K6": 0, "K11b": 0}
    for module, name, key in ((step, "fused_outer_step_plain", "K6"),
                              (kernels, "apply_poisson_plain", "K11b")):
        real = getattr(module, name)

        def wrapped(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)
    launches = (step.LAUNCHES, kernels.MATVEC_LAUNCHES)

    rng = np.random.default_rng(11)
    n = 31
    mesh = nf.StructuredMesh(nx=n, ny=n)
    bc = nf.lid_driven_cavity(1.0)
    dx, dy = mesh.get_cell_sizes()
    s = nf.initialize_state(mesh, bc)
    u = np.asarray(s.u) + 0.01 * rng.normal(size=s.u.shape).astype(np.float32)
    v = np.asarray(s.v) + 0.01 * rng.normal(size=s.v.shape).astype(np.float32)
    p = 0.01 * rng.normal(size=s.p.shape).astype(np.float32)
    cfg = SIMPLEConfig()
    jstep = make_simple_step(
        dx=dx, dy=dy, rho=1.0, mu=0.01, bc=bc, cfg=cfg,
        mom_cfg=dataclasses.replace(MOM, compensated_dots=True, compensated_residual=True),
        pres_cfg=dataclasses.replace(PRES, coarse_rebuild_every=1))
    u1, v1, p1, _, info = jstep(jnp.asarray(u), jnp.asarray(v), jnp.asarray(p),
                                jnp.asarray(0.0, jnp.float32))
    T = torch.as_tensor
    got = step.fused_outer_step("simple", T(u), T(v), T(p), (T(np.float32(0.0)),), dx=dx,
                                dy=dy, rho=1.0, mu=0.01, bc=interop.boundary_conditions(bc),
                                cfg=interop.config(cfg), mom_cfg=interop.config(MOM),
                                pres_cfg=interop.config(PRES))
    for a, b in zip(got[:3], (u1, v1, p1)):
        b = np.asarray(b)
        assert float(np.max(np.abs(a.numpy() - b))) / float(np.max(np.abs(b))) < 2e-4
    assert int(got[4]) == int(info.inner_iterations)

    d_u = (rng.random((n + 1, n)) + 0.2).astype(np.float32)
    d_v = (rng.random((n, n + 1)) + 0.2).astype(np.float32)
    x = rng.normal(size=(n, n)).astype(np.float32)
    want = apply_poisson_pallas(jnp.asarray(x), j_poisson(jnp.asarray(d_u), jnp.asarray(d_v),
                                                          dx=0.05, dy=0.05, rho=1.0,
                                                          variant="consistent"),
                                interpret=True)
    tc = poisson_coefficients(T(d_u), T(d_v), dx=0.05, dy=0.05, rho=1.0, variant="consistent")
    np.testing.assert_allclose(kernels.apply_poisson_kernel(T(x), tc).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    assert calls == {"K6": 1, "K11b": 1}
    assert (step.LAUNCHES, kernels.MATVEC_LAUNCHES) == launches
