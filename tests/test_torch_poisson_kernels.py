"""K11 (``ops/kernels.py``): the plain versions of the whole-array red-black
SOR sweeps and the 5-point matvec against the Pallas kernels in interpret
mode, at ``tests/test_pallas.py``'s shapes and tolerances, and the wrappers'
dispatch rule (a CUDA float32 array of at most 256^2 cells goes to the
kernel, anything else to the plain version)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naviflow_tpu.ops.pallas_kernels import PALLAS_MAX_CELLS as J_MAX_CELLS
from naviflow_tpu.ops.pallas_kernels import apply_poisson_pallas, rbgs_sweeps_pallas
from naviflow_tpu.ops.poisson import poisson_coefficients as j_poisson

from naviflow_tpu_torch.ops import _cuda, kernels
from naviflow_tpu_torch.ops.poisson import poisson_coefficients

torch.set_num_threads(2)


def _system(nx, ny, seed=5):
    """test_pallas.py's system: consistent-variant coefficients from random
    d-fields, random p and b (float32)."""
    rng = np.random.default_rng(seed)
    d_u = (rng.random((nx + 1, ny)) + 0.2).astype(np.float32)
    d_v = (rng.random((nx, ny + 1)) + 0.2).astype(np.float32)
    p = rng.normal(size=(nx, ny)).astype(np.float32)
    b = rng.normal(size=(nx, ny)).astype(np.float32)
    jc = j_poisson(jnp.asarray(d_u), jnp.asarray(d_v), dx=0.05, dy=0.05, rho=1.0,
                   variant="consistent")
    T = lambda x: torch.as_tensor(x)  # noqa: E731
    tc = poisson_coefficients(T(d_u), T(d_v), dx=0.05, dy=0.05, rho=1.0, variant="consistent")
    return (jnp.asarray(p), jnp.asarray(b), jc), (T(p), T(b), tc)


@pytest.mark.parametrize("shape", [(32, 32), (63, 63), (48, 96)])
def test_matvec_plain_matches_pallas(shape):
    (jpp, _, jc), (tpp, _, tc) = _system(*shape)
    want = apply_poisson_pallas(jpp, jc, interpret=True)
    got = kernels.apply_poisson_kernel(tpp, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_sweeps", [1, 3])
def test_rbgs_plain_matches_pallas(n_sweeps):
    (jpp, jb, jc), (tpp, tb, tc) = _system(63, 63)
    want = rbgs_sweeps_pallas(jpp, jb, jc, n_sweeps=n_sweeps, omega=1.5, interpret=True)
    got = kernels.rbgs_sweeps(tpp, tb, tc, n_sweeps=n_sweeps, omega=1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=2e-5)


class _FakeLibrary:
    """Records each C call's integer and float parameters and pointer
    count in place of the CUDA library (both are lean calls)."""

    def __init__(self):
        self.calls = []

    def nf_rbgs_sweeps(self, *args):
        """The lean call: 8 pointers, nx, ny, the launch's sweeps, omega,
        the stream."""
        self.calls.append(("rbgs", 8, tuple(args[8:11]), args[11]))
        return 0

    def nf_apply_poisson(self, *args):
        """The lean call: 7 pointers, nx, ny, the stream."""
        self.calls.append(("matvec", 7, tuple(args[7:9])))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors count as CUDA ones and the library records its calls."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_cuda, "kernel_device", lambda x: True)
    monkeypatch.setattr(_cuda, "require", lambda *a: None)
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_of", lambda x: 0)
    return lib


def test_dispatch_rule(fake_card):
    """At most PALLAS_MAX_CELLS = 256^2 float32 cells go to the kernel (one
    counted launch each); a larger array or another dtype runs the plain
    version, as the JAX wrapper runs its jnp path."""
    assert kernels.PALLAS_MAX_CELLS == J_MAX_CELLS
    r0, m0 = kernels.RBGS_LAUNCHES, kernels.MATVEC_LAUNCHES
    (_, _, _), (p, b, c) = _system(256, 256)
    kernels.rbgs_sweeps(p, b, c, n_sweeps=3, omega=1.5)
    kernels.apply_poisson_kernel(p, c)
    assert fake_card.calls == [("rbgs", 8, (256, 256, 3), 1.5), ("matvec", 7, (256, 256))]
    assert (kernels.RBGS_LAUNCHES, kernels.MATVEC_LAUNCHES) == (r0 + 1, m0 + 1)

    # 257 x 256 cells, and float64 at 63^2: the plain version, no launch
    (_, _, _), (p, b, c) = _system(257, 256)
    want = kernels.rbgs_sweeps_plain(p, b, c, 2, 1.5)
    assert torch.equal(kernels.rbgs_sweeps(p, b, c, n_sweeps=2, omega=1.5), want)
    assert torch.equal(kernels.apply_poisson_kernel(p, c), kernels.apply_poisson_plain(p, c))
    (_, _, _), (p, b, c) = _system(63, 63)
    p64, b64 = p.double(), b.double()
    c64 = type(c)(*(a.double() for a in (c.a_e, c.a_w, c.a_n, c.a_s, c.diag)))
    assert torch.equal(kernels.apply_poisson_kernel(p64, c64), kernels.apply_poisson_plain(p64, c64))
    assert torch.equal(kernels.rbgs_sweeps(p64, b64, c64, n_sweeps=1, omega=1.5),
                       kernels.rbgs_sweeps_plain(p64, b64, c64, 1, 1.5))
    assert len(fake_card.calls) == 2
    assert (kernels.RBGS_LAUNCHES, kernels.MATVEC_LAUNCHES) == (r0 + 1, m0 + 1)


def test_cpu_tensors_run_plain():
    """Without a card, every array runs the plain version."""
    (_, _, _), (p, b, c) = _system(32, 32)
    r0, m0 = kernels.RBGS_LAUNCHES, kernels.MATVEC_LAUNCHES
    assert torch.equal(kernels.rbgs_sweeps(p, b, c, n_sweeps=2, omega=1.5),
                       kernels.rbgs_sweeps_plain(p, b, c, 2, 1.5))
    assert torch.equal(kernels.apply_poisson_kernel(p, c), kernels.apply_poisson_plain(p, c))
    assert (kernels.RBGS_LAUNCHES, kernels.MATVEC_LAUNCHES) == (r0, m0)


def test_coefficients_checked_once_per_set(fake_card, monkeypatch):
    """The lean call checks the iterate every call and a coefficient set's
    arrays once (the operator of a solve is applied to many iterates); a set
    with an array the kernel does not take still raises."""
    checked = []

    def require(x, shape, name):
        checked.append(name)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}")

    monkeypatch.setattr(_cuda, "require", require)
    (_, _, _), (p, _, c) = _system(48, 96)
    for _ in range(3):
        kernels.apply_poisson_kernel(p, c)
    assert sum(name.startswith("coefficients") for name in checked) == 5
    assert sum(name.startswith("input") for name in checked) == 3
    bad = type(c)(c.a_e[:, :-1], c.a_w, c.a_n, c.a_s, c.diag)
    with pytest.raises(ValueError, match="coefficients"):
        kernels.apply_poisson_kernel(p, bad)
    with pytest.raises(ValueError, match="coefficients"):  # still, on the next call
        kernels.apply_poisson_kernel(p, bad)
