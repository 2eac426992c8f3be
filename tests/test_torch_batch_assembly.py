"""The case axis of K8 and K9 in the PyTorch port, on the CPU.

(a) The batched K8's plain version (``ops/assembly.fused_assembly_pair_batched``,
the CPU path and the kernel's oracle) at 64^2, three cases, against
``jax.vmap`` of the JAX package's Pallas ``fused_assembly_pair`` in
interpret mode with one shared viscosity (the JAX kernel closes over
``mu``: under ``jax.vmap`` a per-case viscosity does not trace), and (b)
against one single Pallas call per case with each case's own; each case
bit-equal to its single plain call, a frozen case zeros.  (c) The batched
K9 (``ops/cheby.chebyshev_momentum_strips_batched``) against ``jax.vmap`` of
the Pallas kernel with per-case interval scalars (kernel inputs there), and
its frozen case.  Each at the single kernels' tests' tolerances.  (d) The
batched C entries' slots and case strides, parsed from ``csrc/``, against
the wrappers' pointer arrays through a library that records its calls.
(e) Under ``jvp`` both kernels still raise.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import naviflow_tpu as nf
from naviflow_tpu.core.bc import apply_velocity_bcs
from naviflow_tpu.ops.pallas_assembly import fused_assembly_pair as j_assembly
from naviflow_tpu.ops.pallas_cheby import chebyshev_momentum_strips as j_cheby
from naviflow_tpu.ops.powerlaw import relax_coefficients
from naviflow_tpu.ops.stencil import StencilCoeffs as JStencilCoeffs
from naviflow_tpu.solvers.momentum import (_assemble_coeffs, _chebyshev_bounds,
                                           _u_interior_mask, _v_interior_mask)

from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops import _cuda, assembly, cheby, powerlaw
from naviflow_tpu_torch.ops.stencil import StencilCoeffs

torch.set_num_threads(2)

CSRC = Path(assembly.__file__).resolve().parent.parent / "csrc"
RES = (100.0, 400.0, 1000.0)
ALPHA = 0.7
FIELDS = ("a_e", "a_w", "a_n", "a_s", "a_p", "src")


def T(x):
    return interop.tensor(x, dtype=torch.float32)


def _states(n=64, seed=21):
    """Three noisy BC-applied cavity states, each its own seed."""
    mesh, bc = nf.StructuredMesh(nx=n, ny=n), nf.lid_driven_cavity(1.0)
    st = nf.initialize_state(mesh, bc, dtype=jnp.float32)
    out = []
    for k in range(len(RES)):
        rng = np.random.default_rng(seed + k)
        u = jnp.asarray(st.u + 0.1 * rng.normal(size=st.u.shape), jnp.float32)
        v = jnp.asarray(st.v + 0.1 * rng.normal(size=st.v.shape), jnp.float32)
        p = jnp.asarray(rng.normal(size=st.p.shape), jnp.float32)
        out.append((*apply_velocity_bcs(u, v, bc), p))
    return out, dict(dx=1.0 / (n - 1), dy=1.0 / (n - 1), rho=1.0)


def _flat_jax(out, variant):
    """The JAX kernel's outputs in ``assembly._flat``'s order."""
    cu_un, cu_rel, cv_un, cv_rel = out[:4]
    flat = [getattr(cu_un, f) for f in FIELDS] + [cu_rel.a_p, cu_rel.src]
    flat += [getattr(cv_un, f) for f in FIELDS] + [cv_rel.a_p, cv_rel.src]
    flat += list(out[4:6])
    if variant is not None:
        d_u, d_v, pc = out[6:]
        flat += [d_u, d_v, pc.a_e, pc.a_w, pc.a_n, pc.a_s, pc.diag]
    return flat


def _check_k8(got, want):
    """The single K8 test's tolerances: coefficients rtol/atol 1e-5, maxima
    rtol 1e-6, d and the operator rtol 1e-6 / atol 1e-9."""
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        if k < 16:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=str(k))
        elif k < 18:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=str(k))
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9, err_msg=str(k))


@pytest.mark.parametrize("variant", [None, "consistent"])
def test_k8_batched_plain_matches_jax_vmap_with_shared_mu(variant):
    """The batched K8's plain version at 64^2, three states sharing Re
    100's viscosity (conductance rows equal), with the Gershgorin maxima and
    without or with the consistent fold, against ``jax.vmap`` of the Pallas
    kernel in interpret mode; no launch."""
    states, kw = _states()
    mu = 1.0 / RES[0]
    u, v, p = (jnp.stack([s[i] for s in states]) for i in range(3))
    want = jax.vmap(lambda uu, vv, pp: j_assembly(
        uu, vv, pp, mu=mu, alpha=ALPHA, interpret=True, with_bounds=True,
        poisson_variant=variant, **kw))(u, v, p)
    visc = powerlaw.case_conductances([mu] * 3, kw["dx"], kw["dy"], torch.float32)
    got = assembly.fused_assembly_pair_batched(T(u), T(v), T(p), visc=visc, alpha=ALPHA,
                                               with_bounds=True, poisson_variant=variant, **kw)
    _check_k8(assembly._flat(got, True, variant), _flat_jax(want, variant))
    assert assembly.BATCH_LAUNCHES == 0 and assembly.LAUNCHES == 0


def test_k8_batched_plain_matches_single_pallas_calls_per_mu():
    """The batched K8's plain version with each case's own viscosity (Re
    100 / 400 / 1000, conductance rows) and the consistent fold, against one
    single Pallas call a case in interpret mode; each case bit-equal to its
    single plain call with the Python viscosity; a frozen case gets zeros
    in every output and the others keep their bits."""
    states, kw = _states()
    u, v, p = (T(jnp.stack([s[i] for s in states])) for i in range(3))
    visc = powerlaw.case_conductances([1.0 / r for r in RES], kw["dx"], kw["dy"],
                                      torch.float32)
    args = dict(alpha=ALPHA, with_bounds=True, poisson_variant="consistent", **kw)
    got = assembly._flat(assembly.fused_assembly_pair_batched(u, v, p, visc=visc, **args),
                         True, "consistent")
    for k, (re_, s) in enumerate(zip(RES, states)):
        want = j_assembly(*s, mu=1.0 / re_, interpret=True, **args)
        _check_k8([g[k] for g in got], _flat_jax(want, "consistent"))
        single = assembly._flat(assembly.fused_assembly_pair(u[k], v[k], p[k], mu=1.0 / re_,
                                                             **args), True, "consistent")
        for i, (g, w) in enumerate(zip(got, single)):
            assert torch.equal(g[k], w), (k, i)
    frozen = assembly._flat(assembly.fused_assembly_pair_batched(
        u, v, p, visc=visc, active=torch.tensor([True, False, True]), **args), True,
        "consistent")
    assert len(frozen) == 25
    assert not any(bool(x[1].any()) for x in frozen)
    assert all(torch.equal(f[k], g[k]) for f, g in zip(frozen, got) for k in (0, 2))


def _cheby_cases(is_u, n=64):
    """Three states' relaxed and unrelaxed systems of one field (each at its
    own viscosity) and each one's own Chebyshev interval."""
    states, kw = _states(n, seed=31)
    out = []
    for (u, v, p), re_ in zip(states, RES):
        c_un = _assemble_coeffs(u, v, p, scheme="power_law", is_u=is_u, mu=1.0 / re_, **kw)
        x0 = u if is_u else v
        c_rel = relax_coefficients(c_un, x0, ALPHA)
        mask = _u_interior_mask(u.shape) if is_u else _v_interior_mask(v.shape)
        out.append((x0, c_rel, c_un, _chebyshev_bounds(c_rel, mask)))
    return out


def _stack_c(cs, to=T):
    return StencilCoeffs(*(to(jnp.stack([getattr(c, f) for c in cs])) for f in FIELDS))


@pytest.mark.parametrize("is_u", [True, False], ids=["u", "v"])
def test_k9_batched_plain_matches_jax_vmap_of_pallas(is_u):
    """The batched K9's plain version at 64^2, degree 4, three cases each
    with its own system and interval scalars, against ``jax.vmap`` of the
    Pallas kernel in interpret mode at 2e-5 (the single K9 test's); each
    case bit-equal to its single plain call; a frozen case gets x0 and a
    zero residual and the others keep their bits; no launch."""
    cases = _cheby_cases(is_u)
    x0 = jnp.stack([c[0] for c in cases])
    sc = [jnp.stack([c[3][i] for c in cases]) for i in range(3)]

    def stack_j(k):
        return JStencilCoeffs(*(jnp.stack([getattr(c[k], f) for c in cases]) for f in FIELDS))

    want_x, want_r = jax.vmap(lambda x, cr, cu, th, de, si: j_cheby(
        x, cr, cu, theta=th, delta=de, sigma1=si, degree=4, interpret=True))(
        x0, stack_j(1), stack_j(2), *sc)
    args = dict(theta=T(sc[0]), delta=T(sc[1]), sigma1=T(sc[2]), degree=4)
    c_rel, c_un = _stack_c([c[1] for c in cases]), _stack_c([c[2] for c in cases])
    got_x, got_r = cheby.chebyshev_momentum_strips_batched(T(x0), c_rel, c_un, **args)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=2e-5, atol=2e-5)
    for k, c in enumerate(cases):
        one = cheby.chebyshev_momentum_strips(
            T(c[0]), interop.stencil_coeffs(c[1], dtype=torch.float32),
            interop.stencil_coeffs(c[2], dtype=torch.float32), theta=args["theta"][k],
            delta=args["delta"][k], sigma1=args["sigma1"][k], degree=4)
        assert torch.equal(got_x[k], one[0]) and torch.equal(got_r[k], one[1]), k
    fx, fr = cheby.chebyshev_momentum_strips_batched(
        T(x0), c_rel, c_un, active=torch.tensor([False, True, True]), **args)
    assert torch.equal(fx[0], T(x0)[0]) and not bool(fr[0].any())
    assert torch.equal(fx[1:], got_x[1:]) and torch.equal(fr[1:], got_r[1:])
    assert cheby.BATCH_LAUNCHES == 0 and cheby.LAUNCHES == 0


# ---------------------------------------------------------------------------
# (d) the batched C entries


def _src(name):
    return (CSRC / name).read_text()


def _body(src, signature):
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


class _Recorder:
    """Records the batched entries' arrays."""

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
    monkeypatch.setattr(assembly, "_BATCH", {})
    monkeypatch.setattr(cheby, "_BATCH", {})
    monkeypatch.setattr(assembly, "BATCH_LAUNCHES", 0)
    monkeypatch.setattr(cheby, "BATCH_LAUNCHES", 0)
    return lib


@pytest.mark.parametrize("variant", [None, "consistent"])
def test_k8_batched_slots_match_c_entry(recorder, variant):
    """``nf_fused_assembly_pair_batched`` reads the single entry's slots for
    case 0 (``read_assembly``, the single entry's own reader: 20, 27 with
    the fold), the conductances and the active flags, then the strides of
    all n + 2 (the outputs' one stride: one buffer of case layouts); B
    after the four integers; the persistent blocks walk (case, tile) items,
    each item's view moving u, v, p and the outputs by their strides, De
    and Dn from the case's conductance row read when the walk enters it, a
    frozen case's tiles writing zeros; the entry launches the cases in
    chunks that keep every output index below 2^31.  The wrapper: u, v, p by address and stride (0: shared),
    every output in one buffer of B case layouts (each on a 256-byte
    boundary, stride one layout), the maxima each case's pair from the
    kernel; its host arrays kept across calls."""
    src = _src("assembly.cu")
    entry = _body(src, "NF_EXPORT int nf_fused_assembly_pair_batched(")
    assert "const int n = read_assembly(ptrs, ip, fp, P);" in entry
    assert "const long long* S = ptrs + n + 2;" in entry
    assert "reinterpret_cast<const float*>(ptrs[n]), S[n]," in entry
    assert "reinterpret_cast<const bool*>(ptrs[n + 1]), S[n + 1], ip[4]};" in entry
    assert "if (S[k] != B.so) return (int)cudaErrorInvalidValue;" in entry
    assert "return launch<true>(P, B, ip[3] != 0, (cudaStream_t)stream);" in entry
    single = _body(src, "NF_EXPORT int nf_fused_assembly_pair(")
    assert "read_assembly(ptrs, ip, fp, P);" in single
    assert "return launch<false>(P, AsmCases{}, ip[3] != 0, (cudaStream_t)stream);" in single
    kernel = _body(src, "    assembly_kernel(AsmParams P, AsmCases B) {")
    assert "for (int t = blockIdx.x; t < items; t += gridDim.x) {" in kernel
    assert "const int b = CASES ? t / P.tiles : 0;" in kernel
    for line in ("de = visc[0];", "dn = visc[1];", "on = *shifted(B.active, B.sactive, b);",
                 "const View w = view_of<CASES>(P, B, b, de, dn);",
                 "const int ob = b * (int)(B.so / 4);",
                 "if (BOUNDS && cur >= 0 && on) fold_gmax(shifted(P.gmax, B.so, cur), gu, gv);",
                 "if (CASES && !on) strip<FOLD, BOUNDS, true>(P, w, ob, i0, j0, gu, gv, halo);"):
        assert line in kernel, line
    view = _body(src, "__device__ __forceinline__ View view_of(")
    for line in ("shifted(P.u, B.su, b)", "shifted(P.v, B.sv, b)", "shifted(P.p, B.sp, b)"):
        assert line in view, line
    launch = _body(src, "int launch(AsmParams P, AsmCases B, bool bounds, cudaStream_t s) {")
    assert "C.cases = (int)(cases - c0 < chunk ? cases - c0 : chunk);" in launch
    cases, n = 3, 64
    u, v = torch.zeros(cases, n + 1, n), torch.zeros(cases, n, n + 1)
    p = torch.zeros(n, n).expand(cases, n, n)
    visc = powerlaw.case_conductances([1.0 / r for r in RES], 0.1, 0.1, torch.float32)
    args = dict(dx=0.1, dy=0.1, rho=1.0, visc=visc, alpha=ALPHA, with_bounds=True,
                poisson_variant=variant)
    out = assembly.fused_assembly_pair_batched(u, v, p, **args)
    assembly.fused_assembly_pair_batched(u, v, p, active=torch.tensor([True, False, True]),
                                         **args)
    (e1, p1, ip1, fp1, s1), (_, p2, _, _, _) = recorder.calls
    slots = 27 if variant else 20
    half = slots + 2
    assert e1 == "nf_fused_assembly_pair_batched" and s1 == 7 and len(p1) == 2 * half
    assert ip1 == [n, n, 0 if variant else -1, 1, cases]
    assert fp1[2:4] == [0.0, 0.0] and fp1[:2] == pytest.approx([0.05, 0.05])
    assert p1[:3] == [u.data_ptr(), v.data_ptr(), p.data_ptr()]
    assert p1[half:half + 3] == [4 * (n + 1) * n, 4 * n * (n + 1), 0]
    layout, total = assembly.output_layout(n, n, variant is not None)
    assert len(layout) == slots - 3 and total % 64 == 0
    flat = assembly._flat(out, True, variant)
    assert p1[3:slots] == [flat[0].data_ptr() + 4 * off for off, _ in layout]
    assert p1[half + 3:half + slots] == [4 * total] * (slots - 3)
    assert all(off % 64 == 0 for off, _ in layout)
    assert p1[slots] == visc.data_ptr() and p1[half + slots] == 16
    assert p1[slots + 1] != p2[slots + 1] and p1[half + slots + 1] == 1
    assert tuple(flat[0].shape) == (cases, n + 1, n) and flat[0].stride(0) == total
    assert tuple(flat[16].shape) == (cases,) and flat[16].stride(0) == total
    assert flat[17].data_ptr() == flat[16].data_ptr() + 4
    assert flat[16].data_ptr() == flat[0].data_ptr() + 4 * layout[16][0]
    assert len(assembly._BATCH) == 1 and assembly.BATCH_LAUNCHES == 2


def test_k9_batched_slots_match_c_entry(recorder):
    """``nf_chebyshev_strips_batched`` reads the single entry's 14 slots for
    case 0 (``read_cheby``, the single entry's own reader), the active
    flags, then the strides of all 15; B after the three integers; the
    persistent blocks walk (case, tile) items, each item's view moving
    every pointer (the interval scalars too) by its stride, a frozen case's
    tiles copying x0.  The wrapper: the nine arrays and the three scalars
    by address and stride (0: shared), x* and r halves of one buffer."""
    src = _src("cheby.cu")
    entry = _body(src, "NF_EXPORT int nf_chebyshev_strips_batched(")
    assert "constexpr int N = 14, HALF = N + 1;" in entry
    assert "read_cheby(ptrs, ip, SB.P);" in entry and "read_cheby(ptrs + HALF, ip, SB.S);" in entry
    assert "SB.active = reinterpret_cast<const bool*>(ptrs[N]);" in entry
    assert "SB.cases = ip[3];" in entry
    assert "const int items = SB.cases * SB.P.tiles;" in entry
    assert "read_cheby(ptrs, ip, P);" in _body(src, "NF_EXPORT int nf_chebyshev_strips(")
    case = _body(src, "__device__ __forceinline__ void cheby_case(")
    assert "for (int k = 0; k < 12; ++k) nf_case_shift(*ins[k], *sin[k], b);" in case
    assert "nf_case_shift(P.x_out, SB.S.x_out, b);" in case
    kernel = _body(src, "cheby_kernel_batched(ChebyBatch SB) {")
    assert "cheby_case(SB, n / tiles, V[s ^ 1], on[s ^ 1])" in kernel
    assert "cheby_tile<DEG>(V[s], interval_of(V[s]), t % tiles, stage, sx0, sx1, next);" in kernel
    assert "cheby_frozen_tile<DEG>(V[s], t % tiles);" in kernel
    assert tuple(cheby.SLOTS[9:12]) == ("theta", "delta", "sigma1") and len(cheby.SLOTS) == 14
    cases, ni, nj = 3, 65, 64
    x0 = torch.zeros(cases, ni, nj)
    shared = torch.zeros(ni, nj).expand(cases, ni, nj)
    c_rel = StencilCoeffs(*[torch.zeros(cases, ni, nj) for _ in FIELDS])
    c_un = c_rel.replace(a_p=shared, src=torch.zeros(cases, ni, nj))
    theta = torch.tensor(1.0).expand(cases)
    x, r = cheby.chebyshev_momentum_strips_batched(x0, c_rel, c_un, theta=theta,
                                                   delta=torch.ones(cases),
                                                   sigma1=torch.ones(cases), degree=4)
    (e1, p1, ip1, fp1, s1), = recorder.calls
    half = 15
    assert e1 == "nf_chebyshev_strips_batched" and len(p1) == 2 * half and s1 == 7
    assert ip1 == [ni, nj, 4, cases]
    arrays = [x0, c_rel.a_e, c_rel.a_w, c_rel.a_n, c_rel.a_s, c_rel.a_p, c_rel.src, shared,
              c_un.src]
    assert p1[:9] == [a.data_ptr() for a in arrays]
    assert p1[half:half + 9] == [4 * ni * nj] * 7 + [0, 4 * ni * nj]
    assert p1[half + 9:half + 12] == [0, 4, 4]
    assert p1[12:14] == [x.data_ptr(), r.data_ptr()] and r.data_ptr() - x.data_ptr() == (
        4 * cases * ni * nj)
    assert p1[half + 12:half + 14] == [4 * ni * nj] * 2
    assert p1[half + 14] == 1 and cheby.BATCH_LAUNCHES == 1


# ---------------------------------------------------------------------------
# (e) transforms


def test_k8_k9_raise_under_jvp():
    """Under ``jvp`` K8 and K9 (a batching rule, no derivative) raise at
    their launch on a CUDA tensor, as every kernel does; nothing gives way
    to a plain version."""
    with FakeTensorMode():
        x = torch.zeros(16, 16, device="cuda")
        u, v = torch.zeros(17, 16, device="cuda"), torch.zeros(16, 17, device="cuda")
        c = StencilCoeffs(*[torch.zeros(17, 16, device="cuda")] * 6)
        calls = {
            "K8": (lambda a: assembly.fused_assembly_pair(
                u, v, a, dx=0.1, dy=0.1, rho=1.0, mu=0.01, alpha=0.7)[0].a_p, x),
            "K9": (lambda a: cheby.chebyshev_momentum_strips(
                a, c, c, theta=1.0, delta=0.5, sigma1=2.0, degree=4)[0], u),
        }
        for name, (fn, arg) in calls.items():
            with pytest.raises(RuntimeError, match="cannot run under torch.func"):
                torch.func.jvp(fn, (arg,), (arg,))
