"""The port's rank mesh and explicit decomposition (``parallel/sharding.py``,
``parallel/decompose.py``) and its distributed multigrid
(``parallel/dist_mg.py``) on the CPU (f64).

The blocked layouts (exact, divisible, padded) against the JAX package's;
every halo extension, ``gather_blocks`` and the reductions on 2x2 and 1x4
meshes of gloo ranks against the JAX package's ``shard_map`` outputs on
the matching virtual-device mesh; the distributed Galerkin hierarchy, a
distributed V-cycle and the FMG bootstrap at 32^2 on 2x2 against the
port's single-device multigrid; bring-up without a process group; and a
hung or crashed rank failing its test within the harness's timeout.

The rank bodies run in spawned processes (``tests/torch_ranks.py``), which
import this module: it imports JAX only inside test functions.
"""

import time

import numpy as np
import pytest
import torch

from naviflow_tpu_torch.parallel import decompose as d
from naviflow_tpu_torch.parallel import sharding
from torch_ranks import run_ranks

torch.set_num_threads(2)

EXTENDS = ("extend_u", "extend_v", "extend_p", "extend_u2", "extend_v2", "extend_p2",
           "extend_p_edge")


def _fields(nx, ny, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nx + 1, ny)), rng.normal(size=(nx, ny + 1)),
            rng.normal(size=(nx, ny)))


def _T(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


@pytest.mark.parametrize("nx,ny,mx,my", [(16, 16, 4, 1), (16, 12, 2, 2), (16, 12, 1, 4),
                                         (30, 30, 2, 4), (15, 13, 2, 2)])
def test_blocked_layouts_match_jax(nx, ny, mx, my):
    """``to_blocked_*`` equal the JAX package's bit for bit (exact, divisible
    and zero-padded layouts); ``from_blocked_*`` invert them up to the
    padding."""
    import jax.numpy as jnp

    from naviflow_tpu.parallel import decompose as jd

    u, v, p = _fields(nx, ny)
    for tfn, jfn, x, args in ((d.to_blocked_u, jd.to_blocked_u, u, (mx, my)),
                              (d.to_blocked_v, jd.to_blocked_v, v, (my, mx)),
                              (d.to_blocked_p, jd.to_blocked_p, p, (mx, my))):
        got = tfn(_T(x), *args)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(jnp.asarray(x), *args)))
    ub, vb = d.to_blocked_u(_T(u), mx, my), d.to_blocked_v(_T(v), my, mx)
    np.testing.assert_array_equal(d.from_blocked_u(ub, mx)[: nx + 1, :ny].numpy(), u)
    np.testing.assert_array_equal(d.from_blocked_v(vb, my)[:nx, : ny + 1].numpy(), v)
    dec = d.Decomp(nx=nx, ny=ny, mx=mx, my=my)
    assert ub.shape == (mx * (dec.nxl + 1), my * dec.nyl)
    assert vb.shape == (mx * dec.nxl, my * (dec.nyl + 1))
    assert dec.padded == (nx % mx != 0 or ny % my != 0)


def test_single_rank_bring_up():
    """Without a process group: ``initialize_pod`` is a no-op returning
    False, ``make_device_mesh`` gives a 1x1 mesh with no group whose
    collectives are identities (and are counted), and the most-square rule
    is the JAX package's."""
    assert sharding.initialize_pod(device="cpu") is False
    rm = sharding.make_device_mesh(device="cpu")
    assert (rm.shape, rm.bx, rm.by, rm.group, rm.device.type) == ((1, 1), 0, 0, None, "cpu")
    assert [sharding.most_square(n) for n in (1, 2, 4, 6, 8)] == [
        (1, 1), (1, 2), (2, 2), (2, 3), (2, 4)]
    d.reset_collectives()
    x = _T(np.arange(6.0).reshape(2, 3))
    assert torch.equal(d.gather_blocks(x, rm), x)
    assert float(d.pnorm2(x, rm)) == float(torch.linalg.vector_norm(x))
    assert d.COLLECTIVES == {"p2p": 0, "all_reduce": 1, "all_gather": 1}
    with pytest.raises(ValueError):
        sharding.make_device_mesh(2, device="cpu")


def test_initialize_pod_never_falls_back_to_gloo(monkeypatch):
    """A multi-process bring-up that asks for the card on a machine without
    one raises: NCCL is never quietly replaced by gloo."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.initialize_pod(device="cuda")
    assert not torch.distributed.is_initialized()


def _extend_body(rm, u, v, p):
    """Every halo extension of this rank's blocks, the gathered p, the
    reductions, and the collective counts."""
    nx, ny = p.shape
    mx, my = rm.shape
    dec = d.Decomp(nx=nx, ny=ny, mx=mx, my=my)
    blocks = {"u": d.block(d.to_blocked_u(u, mx, my), rm),
              "v": d.block(d.to_blocked_v(v, my, mx), rm),
              "p": d.block(d.to_blocked_p(p, mx, my), rm)}
    d.reset_collectives()
    out = {name: getattr(d, name)(blocks[name.split("_")[1][0]], dec, rm) for name in EXTENDS}
    out["gather_p"] = d.gather_blocks(blocks["p"], rm)
    out["gather_u"] = d.gather_blocks(blocks["u"], rm)
    out["pnorm2"] = d.pnorm2(blocks["p"], rm)
    out["pmean"] = d.pmean(blocks["p"], nx * ny, rm)
    out["pmax"] = d.pmax(torch.max(blocks["p"]), rm)
    out["collectives"] = dict(d.COLLECTIVES)
    out["coords"] = (rm.bx, rm.by)
    return out


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_extend_and_gather_match_jax_shard_map(shape, tmp_path):
    """On a gloo mesh of ranks, each rank's halo-extended blocks equal the
    JAX package's on the matching device of its ``shard_map`` mesh (bit for
    bit); the gathered arrays and the reductions agree on every rank."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from naviflow_tpu.parallel import decompose as jd
    from naviflow_tpu.parallel.sharding import make_device_mesh

    nx, ny = 16, 12
    u, v, p = _fields(nx, ny, seed=5)
    res = run_ranks(_extend_body, shape, tmp_path, _T(u), _T(v), _T(p))

    mx, my = shape
    dec = jd.Decomp(nx=nx, ny=ny, mx=mx, my=my)
    dmesh = make_device_mesh(mx * my, shape=shape)
    spec = P("x", "y")

    def local(ub, vb, pb):
        out = tuple(getattr(jd, name)({"u": ub, "v": vb, "p": pb}[name.split("_")[1][0]], dec)
                    for name in EXTENDS)
        return out + (jd.gather_blocks(pb), jd.pnorm2(pb))

    fn = jax.jit(shard_map(local, mesh=dmesh, in_specs=(spec,) * 3,
                           out_specs=(spec,) * len(EXTENDS) + (P(), P()), check_vma=False))
    outs = fn(jd.to_blocked_u(jnp.asarray(u), mx, my), jd.to_blocked_v(jnp.asarray(v), my, mx),
              jd.to_blocked_p(jnp.asarray(p), mx, my))
    # one exchange a mesh axis of more than one rank per extension
    p2p = len(EXTENDS) * ((mx > 1) + (my > 1))
    for r, got in enumerate(res):
        bx, by = got["coords"]
        assert (bx, by) == (r // my, r % my)
        for name, blk in zip(EXTENDS, outs):
            a, b = blk.shape[0] // mx, blk.shape[1] // my
            want = np.asarray(blk)[bx * a:(bx + 1) * a, by * b:(by + 1) * b]
            np.testing.assert_array_equal(got[name].numpy(), want, err_msg=f"{name} rank {r}")
        np.testing.assert_array_equal(got["gather_p"].numpy(), np.asarray(outs[-2]))
        np.testing.assert_array_equal(got["gather_u"].numpy(),
                                      d.to_blocked_u(_T(u), mx, my).numpy())
        assert abs(float(got["pnorm2"]) - float(outs[-1])) <= 1e-14 * float(outs[-1])
        assert abs(float(got["pmean"]) - p.mean()) <= 1e-14
        assert float(got["pmax"]) == p.max()
        assert got["collectives"] == {"p2p": p2p, "all_reduce": 3, "all_gather": 2}
        # the reduced values are the same bits on every rank
        for key in ("pnorm2", "pmean"):
            assert float(got[key]) == float(res[0][key])


def _mg_problem(nx=32, seed=0):
    rng = np.random.default_rng(seed)
    d_u = rng.uniform(0.5, 1.5, (nx + 1, nx))
    d_v = rng.uniform(0.5, 1.5, (nx, nx + 1))
    b = rng.normal(size=(nx, nx))
    return d_u, d_v, b - b.mean(), 1.0 / nx


def _mg_cfg(cycle_type="v"):
    from naviflow_tpu_torch.solvers.multigrid import MultigridConfig

    return MultigridConfig(pre_smoothing=2, post_smoothing=2, coarsest_sweeps=16,
                           smoother="gs", cycle_type=cycle_type)


def _mg_body(rm, d_u, d_v, b, h):
    from naviflow_tpu_torch.ops.stencil9 import from_poisson
    from naviflow_tpu_torch.ops.windowed import poisson_coefficients_window
    from naviflow_tpu_torch.parallel import dist_mg as dm

    nx = b.shape[0]
    mx, my = rm.shape
    dec = d.Decomp(nx=nx, ny=nx, mx=mx, my=my)
    du = d.block(d.to_blocked_u(d_u, mx, my), rm)
    dv = d.block(d.to_blocked_v(d_v, my, mx), rm)
    bl = d.block(b, rm)
    st = from_poisson(poisson_coefficients_window(
        du, dv, gi0=rm.bx * dec.nxl, gj0=rm.by * dec.nyl, nx=nx, ny=nx, dx=h, dy=h, rho=1.0,
        variant="consistent"))
    cfg = _mg_cfg()
    dist_levels, tail = dm.build_dist_levels(st, dec, rm, cfg, gather_cutoff=4)
    out = {"levels": [dm._gather_stencil(s, rm) for s, _ in dist_levels]
           + [s for s, _, _, _ in tail], "n_dist": len(dist_levels)}
    e = dm.dist_cycle(torch.zeros_like(bl), bl, dist_levels, tail, 0, cfg, rm)
    out["vcycle"] = d.gather_blocks(e, rm)
    out["fmg"] = d.gather_blocks(dm.dist_fmg(bl, dist_levels, tail, _mg_cfg("fmg"), rm), rm)
    pm, _, cycles = dm.dist_mg_solve(bl, st, dec, rm, cfg, tol=1e-6, max_cycles=40,
                                     gather_cutoff=4)
    out["solve"], out["cycles"] = d.gather_blocks(pm, rm), cycles
    return out


def test_dist_multigrid_matches_single_device(tmp_path):
    """32^2 on a 2x2 gloo mesh with the gather cutoff at 4: the distributed
    levels 32, 16, 8 (Galerkin RAP on blocks) and the gathered 4^2 tail
    equal the single-device hierarchy (rtol 1e-13); a V-cycle, the FMG
    bootstrap and a solve to 1e-6 equal the single-device ones (rel 1e-10)
    on every rank, with the same cycle count."""
    from naviflow_tpu_torch.ops.stencil9 import Stencil9
    from naviflow_tpu_torch.solvers import multigrid as smg

    d_u, d_v, b, h = _mg_problem()
    res = run_ranks(_mg_body, (2, 2), tmp_path, _T(d_u), _T(d_v), _T(b), h)
    cfg = _mg_cfg()
    levels = smg.build_levels(_T(d_u), _T(d_v), cfg, dx=h, dy=h, rho=1.0, variant="consistent")
    tb = _T(b)
    want = {"vcycle": smg._cycle(torch.zeros_like(tb), tb, levels, 0, cfg),
            "fmg": smg._fmg(tb, levels, _mg_cfg("fmg"))}
    solve_cfg = smg.MultigridConfig(tolerance=1e-6, max_cycles=40, check_every=2,
                                    pre_smoothing=2, post_smoothing=2, coarsest_sweeps=16)
    want["solve"], info = smg.multigrid_solve(tb, None, None, torch.zeros_like(tb), solve_cfg,
                                              dx=h, dy=h, rho=1.0, levels=levels)
    for r, got in enumerate(res):
        assert got["n_dist"] == 3
        assert len(got["levels"]) == len(levels) == 4
        for lvl, (st, (st_s, _, _, _)) in enumerate(zip(got["levels"], levels)):
            for f in Stencil9.__dataclass_fields__:
                np.testing.assert_allclose(getattr(st, f).numpy(), getattr(st_s, f).numpy(),
                                           rtol=1e-13, atol=1e-15, err_msg=f"{lvl} {f}")
        for key in ("vcycle", "fmg", "solve"):
            w = want[key].numpy()
            rel = np.max(np.abs(got[key].numpy() - w)) / np.max(np.abs(w))
            assert rel < 1e-10, (r, key, rel)
        assert got["cycles"] == info.iterations
        assert torch.equal(got["solve"], res[0]["solve"])


def _hang_body(rm, hang_rank):
    if rm.rank == hang_rank:
        time.sleep(600)
    return float(d.psum(torch.ones(()), rm))


def _crash_body(rm, crash_rank):
    if rm.rank == crash_rank:
        raise RuntimeError("rank crashed on purpose")
    return float(d.psum(torch.ones(()), rm))


def test_hung_or_crashed_rank_fails_within_timeout(tmp_path):
    """A rank that never joins the collective, or one that raises, fails
    the run with the harness's error within its timeout; the others are
    killed."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks(_hang_body, (1, 2), tmp_path, 1, timeout=6)
    assert time.monotonic() - t0 < 30
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError), match="rank"):
        run_ranks(_crash_body, (1, 2), tmp_path, 1, timeout=20)
    assert time.monotonic() - t0 < 45
