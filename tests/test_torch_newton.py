"""The port's Newton–Krylov solver (``algorithms/newton.py``) against the
JAX package on the CPU (f64, the same inputs): the residual F, the
Jacobian-vector products of ``torch.func.linearize`` and ``torch.func.jvp``
against ``jax.jvp``,
the SIMPLE-type preconditioner, the chunked GMRES against the monolithic
solve, and the kernel gates' refusal under ``torch.func``.  The JAX
package's 31^2 Newton cases from their own warm starts
(``tests/test_newton.py``) are ``test_torch_newton_solve.py`` (power law)
and ``test_torch_newton_quick.py`` (QUICK), files of their own so that the
long runs go to three test workers; each runs the JAX package's solve in a
spawned process beside the port's (``jax_newton_beside``)."""

import concurrent.futures
import functools
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import naviflow_tpu as nf
from naviflow_tpu.algorithms import SIMPLEConfig, simple_solve
from naviflow_tpu.algorithms import newton as jn
from naviflow_tpu.solvers import KrylovMomentumConfig
from naviflow_tpu.solvers.multigrid import MultigridConfig

from naviflow_tpu_torch import interop
from naviflow_tpu_torch.algorithms import newton as tn
from naviflow_tpu_torch.ops import _cuda

torch.set_num_threads(2)

MOM = KrylovMomentumConfig(tolerance=1e-10, max_iterations=100)
PRES = MultigridConfig(tolerance=1e-8, max_cycles=40)


def _T(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-300)


def _setup(nx=31, re=100.0):
    mesh = nf.StructuredMesh(nx=nx, ny=nx)
    fluid = nf.FluidProperties(density=1.0, reynolds_number=re)
    bc = nf.lid_driven_cavity(1.0)
    return mesh, fluid, bc, nf.initialize_state(mesh, bc, dtype=jnp.float64)


def _warm(nx=31, re=100.0, steps=30, scheme="power_law"):
    mesh, fluid, bc, state = _setup(nx, re)
    mom = KrylovMomentumConfig(tolerance=1e-10, max_iterations=100, scheme=scheme)
    warm, _ = simple_solve(mesh, fluid, bc, state, SIMPLEConfig(max_iterations=steps,
                                                                tolerance=0.0),
                           momentum=mom, pressure=PRES, loop="fused")
    return mesh, fluid, bc, warm


def _jax_newton_worker(nx, re, fields, cfg):
    """The JAX package's ``newton_solve`` of ``_setup(nx, re)``'s case from
    the state ``fields`` (u, v, p), in a spawned process with the tests'
    JAX settings (the CPU, float64): its fields and diagnostics in numpy."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    mesh, fluid, bc, _ = _setup(nx, re)
    warm = nf.FlowState(*(jnp.asarray(x) for x in fields))
    fj, dj = jn.newton_solve(mesh, fluid, bc, warm, cfg)
    return dict(u=np.asarray(fj.u), v=np.asarray(fj.v), p=np.asarray(fj.p),
                converged=bool(dj.converged), iterations=int(dj.iterations),
                gmres_iterations=int(dj.gmres_iterations),
                residual_history=np.asarray(dj.residual_history))


def jax_newton_beside(nx, re, warm, cfg):
    """Start ``_jax_newton_worker`` on the JAX state ``warm`` in a spawned
    process and return its future, so that the JAX package's Newton solve
    runs while the port's runs here."""
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    future = pool.submit(_jax_newton_worker, nx, re,
                         tuple(np.asarray(x) for x in (warm.u, warm.v, warm.p)), cfg)
    pool.shutdown(wait=False)
    return future


def _port(mesh, fluid, bc, state):
    return (interop.mesh(mesh), interop.fluid(fluid), interop.boundary_conditions(bc),
            interop.flow_state(state, dtype=torch.float64))


@functools.lru_cache(maxsize=None)
def _pieces(scheme, nx=15, re=400.0):
    """Both packages' residual and flat iterate at a warm state, and a
    seeded direction (made once a module for each scheme and grid: the
    tests read them and change none)."""
    mesh, fluid, bc, warm = _warm(nx, re, steps=6, scheme=scheme)
    dx, dy = mesh.get_cell_sizes()
    shapes = dict(su=warm.u.shape, sv=warm.v.shape, sp=warm.p.shape)
    kw = dict(dx=dx, dy=dy, rho=1.0, mu=fluid.get_viscosity(), scheme=scheme)
    Fj = jn.make_residual(bc=bc, **kw, **shapes)
    Ft = tn.make_residual(bc=interop.boundary_conditions(bc), **kw,
                          **{k: tuple(v) for k, v in shapes.items()})
    rng = np.random.default_rng(3)
    w = np.asarray(jn._flatten(warm.u, warm.v, warm.p)) + 1e-3 * rng.normal(
        size=sum(int(np.prod(s)) for s in shapes.values()))
    z = rng.normal(size=w.shape)
    return mesh, fluid, bc, warm, Fj, Ft, w, z, kw, shapes


@pytest.mark.parametrize("scheme", ["power_law", "quick"])
def test_residual_and_jvp_match_jax(scheme):
    _, _, _, _, Fj, Ft, w, z, _, _ = _pieces(scheme)
    np.testing.assert_allclose(Ft(_T(w)).numpy(), np.asarray(Fj(jnp.asarray(w))),
                               rtol=1e-12, atol=1e-12 * float(np.max(np.abs(Fj(w)))))
    Fj_w, jz = jax.jvp(Fj, (jnp.asarray(w),), (jnp.asarray(z),))
    Fw, lin = torch.func.linearize(Ft, _T(w))
    assert _rel(lin(_T(z)).numpy(), jz) <= 1e-10
    assert _rel(Fw.numpy(), Fj_w) <= 1e-12
    # the traced tangent program is torch.func.jvp's, next to the walls too
    _, tz = torch.func.jvp(Ft, (_T(w),), (_T(z),))
    assert _rel(lin(_T(z)).numpy(), tz.numpy()) <= 1e-14


@pytest.mark.parametrize("scheme", ["power_law", "quick", "luds"])
def test_split_linearization_is_the_jvp(scheme):
    """The traced split (primal program once, tangent program per product)
    gives ``torch.func.jvp``'s bits at an iterate other than the one it was
    traced at, for more than one direction."""
    _, _, _, _, _, Ft, w, z, _, _ = _pieces(scheme, nx=7)
    lin = tn.split_linearization(Ft, _T(w))
    rng = np.random.default_rng(11)
    w2 = _T(w + 1e-2 * rng.normal(size=w.shape))
    Fw, jvp = lin(w2)
    for zz in (_T(z), _T(rng.normal(size=w.shape))):
        ref_F, ref = torch.func.jvp(Ft, (w2,), (zz,))
        assert torch.equal(jvp(zz), ref)
    assert torch.equal(Fw, ref_F)


@pytest.mark.parametrize("shift", [0.0, 2.0])
def test_preconditioner_matches_jax(shift):
    mesh, fluid, bc, warm, _, _, w, z, kw, shapes = _pieces("quick")
    ap_shift = kw["dx"] * kw["dy"] * shift
    pres = MultigridConfig(tolerance=1e-3, max_cycles=12, check_every=4)
    u, v, p = jn._unflatten(jnp.asarray(w), **shapes)
    Mj = jn.make_preconditioner(u, v, p, bc=bc, pres_cfg=pres, momentum_sweeps=2,
                                ap_shift=ap_shift, **kw, **shapes)
    tshapes = {k: tuple(s) for k, s in shapes.items()}
    ut, vt, pt = tn._unflatten(_T(w), **tshapes)
    Mt = tn.make_preconditioner(ut, vt, pt, bc=interop.boundary_conditions(bc),
                                pres_cfg=interop.config(pres), momentum_sweeps=2,
                                ap_shift=ap_shift, **kw, **tshapes)
    assert _rel(Mt(_T(z)).numpy(), Mj(jnp.asarray(z))) <= 1e-10


def test_chunked_gmres_matches_monolithic():
    """A restart cycle is a fresh Arnoldi from the current residual, so the
    chunked solve is the monolithic one: the same Newton trajectory."""
    mesh, fluid, bc, warm = _warm(nx=15, steps=20)
    pres = interop.config(MultigridConfig(tolerance=1e-3, max_cycles=12, check_every=4,
                                          coarsest_sweeps=8))
    base = dict(tolerance=1e-9, scheme="power_law", max_newton=8, gmres_restart=10,
                gmres_maxiter=30)
    out = {chunk: tn.newton_solve(*_port(mesh, fluid, bc, warm),
                                  tn.NewtonConfig(**base, gmres_chunk=chunk), pressure=pres)[1]
           for chunk in (0, 1)}
    assert out[0].converged and out[1].converged
    assert out[0].iterations == out[1].iterations
    assert out[0].gmres_iterations == out[1].gmres_iterations
    np.testing.assert_allclose(out[1].residual_history, out[0].residual_history, rtol=1e-8)


def test_kernel_gates_refuse_under_torch_func():
    """A CUDA kernel has no forward-mode rule: under ``torch.func.jvp`` and
    forward-mode AD the kernel gate and the launch path raise instead of
    switching to the plain version.  Under ``torch.func.vmap`` alone the
    gate answers from the device (K7, K5 and K4 have batching rules) and
    the launch path still raises."""
    x = torch.ones(3, dtype=torch.float64)
    seen = []

    def gate(t):
        seen.append(_cuda.kernel_device(torch.device("cuda")))
        return t

    def launch(t):
        _cuda.library()
        return t

    for fn in (gate, launch):
        with pytest.raises(RuntimeError, match="torch.func"):
            torch.func.jvp(fn, (x,), (x,))
        with torch.autograd.forward_ad.dual_level():
            with pytest.raises(RuntimeError, match="torch.func"):
                fn(x)
    with pytest.raises(RuntimeError, match="torch.func"):
        torch.func.vmap(launch)(x[:, None])
    torch.func.vmap(gate)(x[:, None])
    assert seen == [True]
    assert not _cuda.under_transform()
    assert not _cuda.kernel_device(torch.device("cpu"))


def test_newton_runs_on_the_card_by_default():
    """``newton_solve`` runs on the state's device; the state is the
    card's unless the caller asks for the CPU, and without a card that
    raises."""
    import naviflow_tpu_torch as nt

    mesh = nt.StructuredMesh(nx=15, ny=15)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            nt.initialize_state(mesh, nt.lid_driven_cavity(1.0))
    state = nt.initialize_state(mesh, nt.lid_driven_cavity(1.0), dtype=torch.float64,
                                device="cpu")
    out, diag = tn.newton_solve(mesh, nt.FluidProperties(density=1.0, reynolds_number=100),
                                nt.lid_driven_cavity(1.0), state,
                                tn.NewtonConfig(scheme="power_law", max_newton=1,
                                                gmres_restart=5, gmres_maxiter=5),
                                pressure=interop.config(MultigridConfig(
                                    tolerance=1e-2, max_cycles=4, coarsest_sweeps=8)))
    assert out.u.device.type == "cpu" and diag.iterations == 1
    assert diag.gmres_iterations == 5 and diag.residual_history[1] < diag.residual_history[0]
