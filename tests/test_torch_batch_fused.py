"""Case batching as one device program in the PyTorch port, on the CPU:
K6's batched entry (``ops/step.fused_outer_step_batched``) and the lockstep
loop behind ``batched_cavity_solve`` (``algorithms/base.run_outer_loop_batched``).

(a) The batched plain version of each K6 body on three seeded noisy 31^2
states with three viscosities, against ``jax.vmap`` of the JAX package's
step body with the kernel's semantics (compensated dots and residual, the
coarse operators rebuilt for every solve), against the single plain step of
each case bit for bit, and with one case frozen.  (b) ``batched_cavity_solve``
at 31^2, Re 100 / 400 / 1000, in float64 against the JAX package's
``jax.vmap`` program and the port's single solves
(``tests/test_torch_batch_fused_solve.py``, a file of its own so that the
test workers share the long runs).  (c) With the kernel
gates forced open at 15^2: one batched K6 call a lockstep step and K4 once
a batch, and (d) the batched C entry's slots and case strides against the
wrapper's, through a library that records its calls
(``tests/test_torch_batch_fused_gates.py``, a file of its own so that the
test workers share (a)'s JAX programs and (c)'s solves).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig
from naviflow_tpu.algorithms import piso as jpiso
from naviflow_tpu.algorithms import simple as jsimple
from naviflow_tpu.algorithms import simplec as jsimplec
from naviflow_tpu.algorithms import simpler as jsimpler
from naviflow_tpu.solvers import KrylovMomentumConfig
from naviflow_tpu.solvers.multigrid import MultigridConfig

import naviflow_tpu_torch as nt
from naviflow_tpu_torch import interop
from naviflow_tpu_torch.ops import step

torch.set_num_threads(2)

CSRC = Path(step.__file__).resolve().parent.parent / "csrc"
# the bench's 63^2 headline configuration
MOM = KrylovMomentumConfig(tolerance=1e-6, max_iterations=20)
PRES = MultigridConfig(tolerance=1e-2, max_cycles=6, cycle_type="v", check_every=2,
                       coarsest_sweeps=8, coarse_rebuild_every=8)
# algo -> (JAX step factory, JAX config, the scalar carries of the three cases)
BODIES = {
    "simple": (jsimple.make_simple_step, SIMPLEConfig(), [[0.0], [0.5], [2.0]]),
    "simplec": (jsimplec.make_simplec_step, jsimplec.SIMPLECConfig(),
                [[0.3, float("inf")], [0.3, 1.0], [0.25, 1e-3]]),
    "piso": (jpiso.make_piso_step, jpiso.PISOConfig(), [[0.0], [0.5], [2.0]]),
    "simpler": (jsimpler.make_simpler_step, jsimpler.SIMPLERConfig(), [[0.0], [0.5], [2.0]]),
}
MUS = [1.0 / 100, 1.0 / 400, 1.0 / 1000]


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / (float(np.max(np.abs(want))) + 1e-30)


def _noisy_states(n, seed):
    """Three seeded noisy cavity states (float32 numpy, leading case axis)."""
    rng = np.random.default_rng(seed)
    s = nf.initialize_state(nf.StructuredMesh(nx=n, ny=n), nf.lid_driven_cavity(1.0))
    out = []
    for x, scale in ((s.u, 0.01), (s.v, 0.01), (s.p, 0.0)):
        x = np.asarray(x, dtype=np.float32)
        out.append(np.stack([x + 0.01 * rng.normal(size=x.shape).astype(np.float32)
                             + scale * k for k in range(3)]).astype(np.float32))
    return out


def _port_kw(n, cfg):
    dx, dy = nt.StructuredMesh(nx=n, ny=n).get_cell_sizes()
    return dict(dx=dx, dy=dy, rho=1.0, bc=nt.lid_driven_cavity(1.0),
                cfg=interop.config(cfg), mom_cfg=interop.config(MOM),
                pres_cfg=interop.config(PRES))


@pytest.mark.parametrize("algo", list(BODIES))
def test_k6_batched_plain_matches_jax_vmap_and_single_steps(algo):
    """One batched step of three seeded noisy 31^2 states at Re 100 / 400 /
    1000: each case's u, v, p and scalar results within 2e-4 of ``jax.vmap``
    of the JAX step body with the kernel's semantics and its cycle count
    equal (tests/test_pallas.py's K6 tolerances); each case bit-equal to its
    single plain step; a frozen case gets back its state, its carries and
    its held results, and the other cases are unchanged by its freezing."""
    make_step, jcfg, carries = BODIES[algo]
    n = 31
    mesh, bc = nf.StructuredMesh(nx=n, ny=n), nf.lid_driven_cavity(1.0)
    dx, dy = mesh.get_cell_sizes()
    mom_k6 = dataclasses.replace(MOM, compensated_dots=True, compensated_residual=True)
    pres_k6 = dataclasses.replace(PRES, coarse_rebuild_every=1)

    def one(u, v, p, extra, mu):
        return make_step(dx=dx, dy=dy, rho=1.0, mu=mu, bc=bc, cfg=jcfg, mom_cfg=mom_k6,
                         pres_cfg=pres_k6)(u, v, p, extra)

    u, v, p = _noisy_states(n, seed=5)
    sc = np.asarray(carries, dtype=np.float32)
    extra = (tuple(jnp.asarray(sc[:, k]) for k in range(2)) if algo == "simplec"
             else jnp.asarray(sc[:, 0]))
    ju, jv, jp, jextra, jinfo = jax.jit(jax.vmap(one))(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(p), extra, jnp.asarray(MUS, jnp.float32))

    kw = _port_kw(n, jcfg)
    T = torch.as_tensor
    active = torch.ones(3, dtype=torch.bool)
    got = step.fused_outer_step_batched(algo, T(u), T(v), T(p), T(sc), active, mu=MUS, **kw)
    assert [tuple(x.shape) for x in got[:5]] == [(3, n + 1, n), (3, n, n + 1), (3, n, n),
                                                 (3, 5 if algo == "simplec" else 4), (3,)]
    for b in range(3):
        for name, a, w in (("u", got[0][b], ju[b]), ("v", got[1][b], jv[b]),
                           ("p", got[2][b], jp[b])):
            assert rel_err(a, w) < 2e-4, (b, name, rel_err(a, w))
        assert int(got[4][b]) == int(jinfo.inner_iterations[b]), b
        if algo == "simplec":
            want = (jextra[0][b], jextra[1][b])
        elif algo == "simpler":  # the carry passes through, as in the JAX body
            want = (sc[b, 0],)
        else:
            want = (jextra[b],)
        want += (jinfo.u_norm[b], jinfo.v_norm[b], jinfo.p_norm[b])
        for k, (a, w) in enumerate(zip(got[3][b], want)):
            assert abs(float(a) - float(w)) <= 2e-4 * abs(float(w)) + 1e-6, (b, k)
        single = step.fused_outer_step_plain(algo, T(u[b]), T(v[b]), T(p[b]), tuple(T(sc[b])),
                                             mu=MUS[b], **kw)
        for a, w in zip(got[:3] + got[5:], single[:3] + single[5:]):
            assert torch.equal(a[b], w), b
        assert torch.equal(got[3][b], torch.stack(list(single[3])))
        assert int(got[4][b]) == int(single[4])

    rng = np.random.default_rng(6)
    held = (T(rng.normal(size=tuple(got[3].shape)).astype(np.float32)),
            torch.tensor([3, 7, 11], dtype=torch.int32),
            *(T(rng.normal(size=tuple(x.shape)).astype(np.float32)) for x in got[5:]))
    frozen = step.fused_outer_step_batched(algo, T(u), T(v), T(p), T(sc),
                                           torch.tensor([True, False, True]), mu=MUS,
                                           held=held, **kw)
    n_in = sc.shape[1]
    for a, w in zip(frozen[:3], (u, v, p)):
        assert torch.equal(a[1], T(w[1]))
    assert torch.equal(frozen[3][1, :n_in], T(sc[1]))
    assert torch.equal(frozen[3][1, n_in:], held[0][1, n_in:])
    assert int(frozen[4][1]) == 7
    for a, h in zip(frozen[5:], held[2:]):
        assert torch.equal(a[1], h[1])
    for a, w in zip(frozen, got):
        assert torch.equal(a[0], w[0]) and torch.equal(a[2], w[2])
    bare = step.fused_outer_step_batched(algo, T(u), T(v), T(p), T(sc),
                                         torch.tensor([False, True, True]), mu=MUS, **kw)
    assert int(bare[4][0]) == 0 and not bare[3][0, n_in:].any() and not bare[5][0].any()
    assert step.BATCH_LAUNCHES == 0  # CPU tensors never launch
