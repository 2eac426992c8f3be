"""The case axis of K10a and K10b in the PyTorch port, on the CPU.

(a) The batched K10a / K10b plain versions
(``ops/plane_strip.plane_strip_down_batched`` / ``plane_strip_up_batched``,
the CPU path and the kernels' oracles) on three seeded 64^2 levels in
colour planes (1 and 2 sweeps) against ``jax.vmap`` of the JAX package's
Pallas ``plane_strip_down`` / ``plane_strip_up`` in interpret mode, at
``tests/test_torch_plane.py``'s tolerances; each case bit-equal to its
single plain call; frozen cases.  (b) The batched C entries' slots and
case strides, parsed from ``csrc/plane.cu``, against the wrappers' pointer
arrays through a library that records its calls.  (c) Under ``jvp`` both
kernels still raise.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from naviflow_tpu.ops import pallas_plane as jpp
from naviflow_tpu.ops import plane as jp
from naviflow_tpu.ops.poisson import poisson_coefficients as j_poisson
from naviflow_tpu.ops.stencil9 import from_poisson as j_from_poisson
from naviflow_tpu.solvers.multigrid import MultigridConfig

from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops import _cuda, plane_strip
from naviflow_tpu_torch.ops import plane as tp

torch.set_num_threads(2)

CSRC = Path(plane_strip.__file__).resolve().parent.parent / "csrc"
NX, CASES = 64, 3
CFG = MultigridConfig(pre_smoothing=1, post_smoothing=1, smoother="gs")
NAMES = ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")


def _cases(seed=17):
    """Three consistent-variant 64^2 stencils from seeded d-fields, each with
    its own b, p and coarse correction (float32, JAX arrays)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(CASES):
        d_u = jnp.asarray(rng.uniform(0.5, 1.5, (NX + 1, NX)), jnp.float32)
        d_v = jnp.asarray(rng.uniform(0.5, 1.5, (NX, NX + 1)), jnp.float32)
        st = j_from_poisson(j_poisson(d_u, d_v, dx=1.0 / NX, dy=1.0 / NX, rho=1.0,
                                      variant="consistent"))
        p, b = (jnp.asarray(rng.normal(size=(NX, NX)), jnp.float32) for _ in range(2))
        ec = jnp.asarray(rng.normal(size=(NX // 2, NX // 2)), jnp.float32)
        out.append(dict(st=st, p=p, b=b, ec=ec))
    return out


def _stack(cases, key):
    return jnp.stack([c[key] for c in cases])


def _jax_st(cases):
    return type(cases[0]["st"])(**{k: jnp.stack([getattr(c["st"], k) for c in cases])
                                   for k in NAMES})


def _port(cases):
    """The port's side: each case's PlaneStencil5 and planes, and the
    batched ``PlaneArrays`` and planes stacked from them."""
    pss, planes = [], []
    for c in cases:
        pss.append(tp.PlaneStencil5(interop.stencil9(c["st"], dtype=torch.float32),
                                    interop.tensor(c["b"], dtype=torch.float32)))
        planes.append(tp.split_planes(interop.tensor(c["p"], dtype=torch.float32)))
    norm = [torch.stack([plane_strip._norm_arrays(ps)[i] for ps in pss]) for i in range(10)]
    ps_b = plane_strip.PlaneArrays(norm, [torch.stack([ps.c[i] for ps in pss]) for i in (0, 1)],
                                   torch.stack([ps.rc_zdiag for ps in pss]))
    R, B = (torch.stack([pl[i] for pl in planes]) for i in (0, 1))
    ec = interop.tensor(_stack(cases, "ec"), dtype=torch.float32)
    return pss, ps_b, R, B, ec


@pytest.mark.parametrize("sweeps", [1, 2])
def test_k10_batched_plain_matches_jax_vmap_of_pallas(sweeps):
    """K10a then K10b on three 64^2 levels against ``jax.vmap`` of the Pallas
    plane kernels (interpret mode) at rtol 1e-5 / atol 1e-4; each case
    bit-equal to its single plain call; no launch."""
    cases = _cases()
    cfg = dataclasses.replace(CFG, pre_smoothing=sweeps, post_smoothing=sweeps)
    tcfg = interop.config(cfg)

    def down(st, b, p):
        return jpp.plane_strip_down(*jp.split_planes(p), jp.PlaneStencil5(st, b), cfg,
                                    interpret=True)

    def up(st, b, R, B, ec):
        return jpp.plane_strip_up(R, B, jp.PlaneStencil5(st, b), ec, cfg, interpret=True)

    st, b = _jax_st(cases), _stack(cases, "b")
    want_d = jax.vmap(down)(st, b, _stack(cases, "p"))
    want_u = jax.vmap(up)(st, b, want_d[0], want_d[1], _stack(cases, "ec"))
    pss, ps_b, R, B, ec = _port(cases)
    got_d = plane_strip.plane_strip_down_batched(R, B, ps_b, tcfg)
    got_u = plane_strip.plane_strip_up_batched(got_d[0], got_d[1], ps_b, ec, tcfg)
    for g, w in zip(got_d + got_u, tuple(want_d) + tuple(want_u)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)
    for k in range(CASES):
        one_d = plane_strip.plane_strip_down(R[k], B[k], pss[k], tcfg)
        one_u = plane_strip.plane_strip_up(got_d[0][k], got_d[1][k], pss[k], ec[k], tcfg)
        assert all(torch.equal(g[k], o) for g, o in zip(got_d + got_u, one_d + one_u)), k
    assert plane_strip.DOWN_BATCH_LAUNCHES == plane_strip.UP_BATCH_LAUNCHES == 0
    assert plane_strip.DOWN_LAUNCHES == plane_strip.UP_LAUNCHES == 0


def test_k10_batched_frozen_case():
    """A frozen case (the middle one): K10a gives back its R and B and a zero
    coarse residual, K10b its R and B; the other cases keep their bits."""
    _, ps_b, R, B, ec = _port(_cases(seed=19))
    tcfg = interop.config(CFG)
    active = torch.tensor([True, False, True])
    full_d = plane_strip.plane_strip_down_batched(R, B, ps_b, tcfg)
    fz_d = plane_strip.plane_strip_down_batched(R, B, ps_b, tcfg, active=active)
    assert torch.equal(fz_d[0][1], R[1]) and torch.equal(fz_d[1][1], B[1])
    assert not bool(fz_d[2][1].any()) and tuple(fz_d[2].shape) == (CASES, NX // 2, NX // 2)
    full_u = plane_strip.plane_strip_up_batched(R, B, ps_b, ec, tcfg)
    fz_u = plane_strip.plane_strip_up_batched(R, B, ps_b, ec, tcfg, active=active)
    assert torch.equal(fz_u[0][1], R[1]) and torch.equal(fz_u[1][1], B[1])
    for fz, full in ((fz_d, full_d), (fz_u, full_u)):
        assert all(torch.equal(f[k], g[k]) for f, g in zip(fz, full) for k in (0, 2))


# ---------------------------------------------------------------------------
# (b) the batched C entries


def _body(src, signature):
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("_batched"):
            return lambda ptrs, ip, fp, stream: self.calls.append(
                (name, list(ptrs), list(ip), list(fp), stream)) or 0
        raise AttributeError(name)


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_of", lambda x: 7)
    monkeypatch.setattr(_cuda, "kernel_device", lambda x: True)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for name in ("_DOWN_BATCH", "_UP_BATCH"):
        monkeypatch.setattr(plane_strip, name, {})
    for name in ("DOWN_BATCH_LAUNCHES", "UP_BATCH_LAUNCHES"):
        monkeypatch.setattr(plane_strip, name, 0)
    return lib


@pytest.mark.parametrize("down", [True, False], ids=["down", "up"])
def test_k10_batched_slots_match_c_entry(recorder, down):
    """``nf_plane_strip_down_batched`` / ``nf_plane_strip_up_batched`` read
    the single entry's slots for case 0 (``read_plane``, the single entry's
    own reader: 18 / 15), the active flags, then the strides of all of
    them; B after the three integers; the grid's z axis is the cases, each
    block's view moving every pointer by its stride; a frozen case's blocks
    copy R and B (and zero rc).  The wrapper: the inputs by address and
    stride (0: shared), the outputs one buffer of B case parts."""
    src = (CSRC / "plane.cu").read_text()
    entry = _body(src, "int launch_batched(")
    assert "const int half = (down ? 18 : 15) + 1;" in entry
    assert "read_plane(down, ptrs, ip, SB.P);" in entry
    assert "read_plane(down, ptrs + half, ip, SB.S);" in entry
    assert "const int cases = ip[3];" in entry
    assert "read_plane(down, ptrs, ip, P);" in _body(src, "int launch(")
    case = _body(src, "__device__ __forceinline__ bool plane_case(")
    assert "const int b = (int)blockIdx.z;" in case
    for field in ("P.R, SB.S.R", "P.nrm[k], SB.S.nrm[k]", "P.rc_zdiag, SB.S.rc_zdiag",
                  "P.ec, SB.S.ec", "P.out_rc, SB.S.out_rc"):
        assert f"nf_case_shift({field}, b);" in case
    assert "dim3((P.nc + TJ - 1) / TJ, (P.m + TI - 1) / TI, cases)" in src
    assert ("true" if down else "false") in _body(
        src, f"NF_EXPORT int nf_plane_strip_{'down' if down else 'up'}_batched(")
    m, nc, cells = NX, NX // 2, NX * NX // 2
    R, B = torch.zeros(CASES, m, nc), torch.zeros(CASES, m, nc)
    shared = torch.zeros(m, nc).expand(CASES, m, nc)
    norm = [torch.zeros(CASES, m, nc) for _ in range(9)] + [shared]
    ps = plane_strip.PlaneArrays(norm, [torch.zeros(CASES, m, nc)] * 2,
                                 torch.zeros(CASES, m // 2, nc))
    cfg = interop.config(CFG)
    active = torch.tensor([True, False, True])
    if down:
        out = plane_strip.plane_strip_down_batched(R, B, ps, cfg, active=active)
        ins = [R, B, *plane_strip._norm_arrays(ps), *ps.c, ps.rc_zdiag]
        strides = [4 * cells] * 11 + [0] + [4 * cells] * 2 + [4 * cells // 2]
        total = 2 * cells + cells // 2
    else:
        ec = torch.zeros(CASES, m // 2, nc)
        out = plane_strip.plane_strip_up_batched(R, B, ps, ec, cfg, active=active)
        ins = [R, B, *plane_strip._norm_arrays(ps), ec]
        strides = [4 * cells] * 11 + [0] + [4 * cells // 2]
        total = 2 * cells
    (e1, p1, ip1, fp1, s1), = recorder.calls
    n_in, half = len(ins), len(ins) + len(out) + 1
    assert e1 == f"nf_plane_strip_{'down' if down else 'up'}_batched" and s1 == 7
    assert len(p1) == 2 * half and ip1 == [m, nc, 1, CASES]
    assert p1[:n_in] == [a.data_ptr() for a in ins] and p1[half:half + n_in] == strides
    assert p1[n_in:half - 1] == [o.data_ptr() for o in out]
    assert p1[half + n_in:2 * half - 1] == [4 * total] * len(out)
    assert p1[half - 1] == active.data_ptr() and p1[2 * half - 1] == 1
    assert out[1].data_ptr() - out[0].data_ptr() == 4 * cells
    assert (plane_strip.DOWN_BATCH_LAUNCHES, plane_strip.UP_BATCH_LAUNCHES) == (
        (1, 0) if down else (0, 1))


# ---------------------------------------------------------------------------
# (c) transforms


def test_k10_raise_under_jvp():
    """Under ``jvp`` K10a and K10b (a batching rule, no derivative) raise at
    their launch on a CUDA tensor, as every kernel does."""
    with FakeTensorMode():
        x = torch.zeros(64, 32, device="cuda")
        ps = plane_strip.PlaneArrays([torch.zeros(64, 32, device="cuda")] * 10,
                                     [torch.zeros(64, 32, device="cuda")] * 2,
                                     torch.zeros(32, 32, device="cuda"))
        cfg = interop.config(CFG)
        calls = {
            "K10a": lambda a: plane_strip.plane_strip_down(a, a, ps, cfg)[0],
            "K10b": lambda a: plane_strip.plane_strip_up(
                a, a, ps, torch.zeros(32, 32, device="cuda"), cfg)[0],
        }
        for name, fn in calls.items():
            with pytest.raises(RuntimeError, match="cannot run under torch.func"):
                torch.func.jvp(fn, (x,), (x,))
