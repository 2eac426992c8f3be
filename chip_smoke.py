#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``naviflow_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero with no
result line:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the kernel build: ``nvcc`` compiles ``naviflow_tpu_torch/csrc/*.cu`` for
   sm_90a from the checkout, one process per source;
3. each kernel against its plain PyTorch version on the card, with the
   tolerance of the JAX package's test of that kernel and both times (CUDA
   events, turns plain / kernel / kernel / plain): K1, K2 and K3 at the
   shapes the 1024^2 path gives them; K7 on the u and v systems of a 63^2
   cavity state (maxiter 3 and 20); K4 on 63^2 and 255^2 vertex
   hierarchies; K5 on the 63^2 hierarchy at the headline configuration and
   at tolerance 1e-4 / 30 cycles; K6 over 3 chained 63^2 steps from rest
   and one 255^2 step; K3 on the 63^2 -> 7^2 vertex hierarchy.  Beside them
   the time of one grid-wide barrier at each kernel's grid size;
4. the 1024^2 slice: ``simple_solve`` at 1024^2, Re=100, with the bench's
   large-grid configuration (Chebyshev momentum of degree 4, one fixed
   V-cycle with 1/1 smoothing, 32 coarsest sweeps, coarse rebuild every 8
   steps) for 40 outer steps, with the kernels and with
   ``backend='composed'``: launches K1 = 40, strip_down = 80, strip_up =
   80, K3 = 40; residual history finite and falling; final residual within
   5% of the composed run's (the kernel run's momentum bounds lag a step);
5. the 63^2 headline: ``simple_solve`` at 63^2, Re=100, with the bench's
   headline configuration (BiCGSTAB momentum to 1e-6 in <= 20 iterations;
   V-cycles to 1e-2, <= 6, checked every 2, 8 coarsest sweeps, coarse
   rebuild every 8 steps) to 1e-3 and to 1e-5, with the kernels and
   composed: every kernel-run step is one K6 launch, K4 runs once (the
   lagged carry's setup rebuild) and nothing else launches; kernel and
   composed outer iterations within 2% or 2; Ghia infinity error below 0.10
   at 1e-5; a ``torch.profiler`` window of 20 kernel steps;
6. the FMG run: the same case with ``cycle_type='fmg'`` (which the K6 gate
   refuses) for 40 steps: launches K7 = 80, K5 = 40, K4 = 1 + 5 refreshes,
   nothing else; residual finite, falling, within 5% of the composed run.

Then a JSON line with every kernel's launches, error, times and bound, the
card's name and power limit, and, last, ``{"ok": true, "device": {...}}``.
Needs no network and no JAX; there is no CPU path.
"""

import contextlib
import ctypes
import json
import math
import subprocess
import sys
import time

N = 1024  # grid of the large-grid path (bench.py large-grid row)
STEPS = 40
NH = 63  # the headline grid (bench.py main)
NH_BIG = 255  # the largest grid the K6 gate admits
FMG_STEPS = 40
RE = 100.0
SEED = 0
REPS = 20  # timed launches per kernel measurement

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
# float32 FLOP/s outside the tensor cores.  bound_ms of a kernel is the
# larger of its bytes over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Operation counts per element used in the bounds: a 5- / 9-point stencil
# apply, a compensated (Dot2) product-and-accumulate, a Gauss-Seidel update
# beyond its stencil apply.
APPLY5, APPLY9, DOT2, GS_UPDATE = 9, 17, 25, 3


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def torch_sync():
    import torch

    torch.cuda.synchronize()


def time_pair(plain, kernel, reps=REPS):
    """ms per call of each, in turns plain, kernel, kernel, plain."""
    import torch

    def once(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    p1, k1, k2, p2 = once(plain), once(kernel), once(kernel), once(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def max_err(got, want):
    """(max abs error, max abs error / max |want|)."""
    a = float((got.double() - want.double()).abs().max())
    return a, a / (float(want.double().abs().max()) + 1e-30)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time for the bytes and operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# grid-wide barriers: the unit of the whole-algorithm kernels' bound


def grid_sync_ms(cells, dev):
    """ms of one grid-wide barrier in a cooperative launch sized for
    ``cells`` cells (nf_grid_sync_probe: 1 and 2001 barriers, the
    difference over 2000)."""
    import torch

    from naviflow_tpu_torch.ops import _cuda

    lib = _cuda.library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(syncs, reps=5):
        ip = (ctypes.c_int * 2)(cells, syncs)
        ptrs = (ctypes.c_longlong * 1)(0)
        fp = (ctypes.c_float * 1)(0.0)
        _cuda.check(lib.nf_grid_sync_probe(ptrs, ip, fp, stream), "grid_sync_probe")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            _cuda.check(lib.nf_grid_sync_probe(ptrs, ip, fp, stream), "grid_sync_probe")
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    return (run(2001) - run(1)) / 2000


class Barriers:
    """Counts the grid-wide barriers of the device code in csrc/coop.cuh,
    krylov.cuh and mg.cuh, pass by pass (NF_PASS: a pass over <= 1,024
    cells runs in block 0 alone and owes one barrier before the next
    grid-wide pass)."""

    SMALL = 1024

    def __init__(self):
        self.n, self.pending = 0, False

    def settle(self):
        if self.pending:
            self.n, self.pending = self.n + 1, False

    def pass_(self, cells):
        if cells <= self.SMALL:
            self.pending = True
        else:
            self.settle()
            self.n += 1

    def grid(self, k=1):  # grid passes and reductions: one barrier each
        self.settle()
        self.n += k

    def smooth(self, cells, five, sweeps):
        for _ in range(sweeps * (2 if five else 4)):
            self.pass_(cells)

    def vcycle(self, meta, cfg):
        cells = [a * b for (a, b), _ in meta]
        fives = [five for _, five in meta]
        for lvl in range(len(cells) - 1):
            self.smooth(cells[lvl], fives[lvl], cfg.pre_smoothing)
            self.pass_(cells[lvl + 1])
        self.smooth(cells[-1], fives[-1], cfg.coarsest_sweeps)
        for lvl in range(len(cells) - 2, -1, -1):
            self.pass_(cells[lvl])
            self.smooth(cells[lvl], fives[lvl], cfg.post_smoothing)

    def mg_solve(self, meta, cfg, cycles, mean_normalize=True):
        self.grid()  # ||b||
        for _ in range(cycles // cfg.check_every):
            for _ in range(cfg.check_every):
                self.vcycle(meta, cfg)
            self.grid()  # residual norm
        self.settle()
        if mean_normalize:
            self.grid(2)  # mean, subtract
        self.grid()  # final residual

    def rap(self, meta):
        for (a, b), _ in meta[1:]:
            self.pass_(a * b)

    def bicgstab(self, iterations):
        self.grid(3 + 5 * iterations)


# ---------------------------------------------------------------------------
# work of each kernel (bytes moved once, operations) from its inputs; a
# hierarchy's ``meta`` is its [((ni, nj), five_point), ...], finest first


def meta_of(levels):
    return [(tuple(shp), five) for _, shp, five, _ in levels]


def _apply_ops(five):
    return APPLY5 if five else APPLY9


def cycle_flops(meta, cfg):
    cells = [a * b for (a, b), _ in meta]
    ops = [_apply_ops(five) for _, five in meta]
    f = 0
    for lvl in range(len(cells) - 1):
        f += (cfg.pre_smoothing + cfg.post_smoothing) * cells[lvl] * (ops[lvl] + GS_UPDATE)
        f += cells[lvl] * (ops[lvl] + 1) + 12 * cells[lvl + 1] + 4 * cells[lvl]
    f += cfg.coarsest_sweeps * cells[-1] * (ops[-1] + GS_UPDATE)
    return f


def hierarchy_bytes(meta):
    return 4 * sum((5 if five else 9) * a * b for (a, b), five in meta)


def vcycle_work(meta, cfg):
    c0 = meta[0][0][0] * meta[0][0][1]
    return hierarchy_bytes(meta) + 4 * 3 * c0, cycle_flops(meta, cfg)  # + p, b in; p out


def mg_solve_work(meta, cfg, cycles):
    c0 = meta[0][0][0] * meta[0][0][1]
    a0 = _apply_ops(meta[0][1])
    flops = cycles * cycle_flops(meta, cfg)
    flops += (cycles // cfg.check_every + 2) * c0 * (a0 + 1 + DOT2) + 2 * c0
    return hierarchy_bytes(meta) + 4 * 4 * c0, flops  # + p0, b in; p, r out


def rap_work(meta):
    """Each coarse entry: 9 fine points x the fine stencil's taps, 3
    operations each, over 9 offsets."""
    flops = sum(9 * (9 * (5 if five_f else 9) * 3 + 12) * a * b
                for ((_, five_f), ((a, b), _)) in zip(meta, meta[1:]))
    return hierarchy_bytes(meta), flops


def bicgstab_work(n, iterations):
    flops = n * (APPLY5 + 3 * DOT2 + 1) + iterations * n * (2 * APPLY5 + 5 * DOT2 + 12)
    return 8 * 4 * n, flops  # x0 and six coefficient arrays in, x out


def step_work(nx, meta, cfg, k_total, cycles):
    nu, nv, np_ = (nx + 1) * nx, nx * (nx + 1), nx * nx
    faces = nu + nv
    byts = 4 * (3 * faces + 3 * np_)  # u, v, p in; u', v', p', r_u, r_v, r_p out
    # assembly, compensated residuals, corrections per face; continuity,
    # operator and norm per cell
    flops = faces * (70 + 6 * (2 + 6 + 17) + 2 * DOT2 + 8) + np_ * (20 + DOT2 + 3)
    flops += (2 * (APPLY5 + 3 * DOT2 + 1) * max(nu, nv)
              + k_total * max(nu, nv) * (2 * APPLY5 + 5 * DOT2 + 12))
    flops += rap_work(meta)[1] + mg_solve_work(meta, cfg, cycles)[1]
    return byts, flops


@contextlib.contextmanager
def count_applies():
    """Count the plain BiCGSTAB's stencil applies (2 per iteration + 1)."""
    from naviflow_tpu_torch.solvers import momentum

    real, box = momentum._apply, [0]

    def counted(x, c):
        box[0] += 1
        return real(x, c)

    momentum._apply = counted
    try:
        yield box
    finally:
        momentum._apply = real


# ---------------------------------------------------------------------------
# the 1024^2 kernels (K1, K2, K3)


def cavity_fields(n, dev):
    """A lid-driven-cavity state plus seeded noise, BCs applied."""
    import numpy as np
    import torch

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.core.bc import apply_velocity_bcs

    rng = np.random.default_rng(SEED)
    mesh = nt.StructuredMesh(nx=n, ny=n)
    bc = nt.lid_driven_cavity(1.0)
    st = nt.initialize_state(mesh, bc, device=dev)

    def noise(shape, scale):
        return torch.as_tensor(scale * rng.normal(size=shape), dtype=torch.float32, device=dev)

    u, v = apply_velocity_bcs(st.u + noise(st.u.shape, 0.1), st.v + noise(st.v.shape, 0.1), bc)
    p = noise(st.p.shape, 1.0)
    return u, v, p, dict(dx=mesh.dx, dy=mesh.dy, rho=1.0, mu=1.0 / RE)


def check_asmcheby(dev):
    from naviflow_tpu_torch.ops import asmcheby
    from naviflow_tpu_torch.ops.powerlaw import relax_coefficients, u_momentum_coefficients
    from naviflow_tpu_torch.ops.powerlaw import v_momentum_coefficients
    from naviflow_tpu_torch.solvers.momentum import (_bounds_from_rho, _u_interior_mask,
                                                     _v_interior_mask)

    u, v, p, kw = cavity_fields(N, dev)
    alpha, degree = 0.7, 4
    rho_u = asmcheby._masked_ratio_max(
        relax_coefficients(u_momentum_coefficients(u, v, p, **kw), u, alpha),
        _u_interior_mask(u.shape, device=dev))
    rho_v = asmcheby._masked_ratio_max(
        relax_coefficients(v_momentum_coefficients(u, v, p, **kw), v, alpha),
        _v_interior_mask(v.shape, device=dev))
    args = dict(alpha=alpha, degree=degree, bounds_u=_bounds_from_rho(rho_u, 1.05),
                bounds_v=_bounds_from_rho(rho_v, 1.05), poisson_variant="consistent", **kw)
    got = asmcheby.fused_asmcheby_pair(u, v, p, **args)
    want = asmcheby.fused_asmcheby_pair_plain(u, v, p, **args)
    torch_sync()
    # tolerances of tests/test_pallas_asmcheby.py, relative to each output's scale
    names = ["u_star", "r_u", "v_star", "r_v", "d_u", "d_v"]
    tols = [2e-5, 5e-5, 2e-5, 5e-5, 2e-5, 2e-5]
    pairs = list(zip(got[:6], want[:6]))
    for name in ("a_e", "a_w", "a_n", "a_s", "diag"):
        names.append("pc." + name)
        tols.append(2e-5)
        pairs.append((getattr(got[6], name), getattr(want[6], name)))
    names += ["rho_u", "rho_v"]
    tols += [1e-6, 1e-6]
    pairs += [(got[7], want[7]), (got[8], want[8])]
    errs = {}
    worst_abs, ok = 0.0, True
    for name, tol, (g, w) in zip(names, tols, pairs):
        a, r = max_err(g, w)
        errs[name] = r
        worst_abs = max(worst_abs, a)
        ok &= r < tol
    ms, plain_ms = time_pair(lambda: asmcheby.fused_asmcheby_pair_plain(u, v, p, **args),
                             lambda: asmcheby.fused_asmcheby_pair(u, v, p, **args))
    faces = 2 * N * (N + 1)
    nbytes = 4 * (3 * faces + N * N + 4 * faces + 5 * N * N)  # u, v, p in; 6 fields + pc out
    flops = faces * (70 + degree * (APPLY5 + 8) + 10) + 10 * N * N
    return dict(name="fused_asmcheby_pair", shape=[N, N], degree=degree, ok=ok,
                max_abs_err=worst_abs, rel_err=errs, ms=ms, plain_ms=plain_ms,
                work=(nbytes, flops))


def fine_levels(dev):
    """The 1024^2 hierarchy from random d-fields: level 0 (5-point),
    1 (512^2 Galerkin 9-point), and the 256^2 -> 4^2 tail."""
    import numpy as np
    import torch

    from naviflow_tpu_torch.solvers.multigrid import MultigridConfig, build_levels

    rng = np.random.default_rng(SEED + 1)
    d_u = torch.as_tensor(rng.uniform(0.5, 1.5, (N + 1, N)), dtype=torch.float32, device=dev)
    d_v = torch.as_tensor(rng.uniform(0.5, 1.5, (N, N + 1)), dtype=torch.float32, device=dev)
    cfg = MultigridConfig(tolerance=0.0, max_cycles=1, pre_smoothing=1, post_smoothing=1,
                          coarsest_sweeps=32, coarse_rebuild_every=8)
    levels = build_levels(d_u, d_v, cfg, dx=1.0 / (N - 1), dy=1.0 / (N - 1), rho=1.0,
                          variant="consistent")
    return levels, cfg, rng


def check_strips(dev, levels, cfg, rng):
    import torch

    from naviflow_tpu_torch.ops import strip

    rows = []
    for lvl in (0, 1):
        st, (n, _), five, _ = levels[lvl]

        def rnd(shape):
            return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)

        p, b, ec = rnd((n, n)), rnd((n, n)), rnd((n // 2, n // 2))
        got_x, got_rc = strip.strip_down(p, b, st, cfg, five)
        want_x, want_rc = strip.strip_down_plain(p, b, st, cfg, five)
        got_up = strip.strip_up(want_x, b, st, ec, cfg, five)
        want_up = strip.strip_up_plain(want_x, b, st, ec, cfg, five)
        torch_sync()

        # tests/test_pallas_strip.py holds the strips to rtol 1e-5, atol 1e-4
        # on fields of magnitude ~100; the atol is that test's noise floor, so
        # it scales with the field: 1e-4 * max|want| / 100 (the 512^2
        # Galerkin level's fields here are ~10x larger)
        def close(g, w):
            atol = max(1e-4, 1e-6 * float(w.abs().max()))
            return bool(torch.allclose(g, w, rtol=1e-5, atol=atol))

        down_ok = close(got_x, want_x) and close(got_rc, want_rc)
        up_ok = close(got_up, want_up)
        ms_d, plain_d = time_pair(lambda: strip.strip_down_plain(p, b, st, cfg, five),
                                  lambda: strip.strip_down(p, b, st, cfg, five))
        ms_u, plain_u = time_pair(lambda: strip.strip_up_plain(want_x, b, st, ec, cfg, five),
                                  lambda: strip.strip_up(want_x, b, st, ec, cfg, five))
        cells, a, taps = n * n, _apply_ops(five), (5 if five else 9)
        down_work = (4 * (cells * (2 + taps) + cells + cells // 4),
                     cells * (cfg.pre_smoothing * (a + GS_UPDATE) + a + 1) + 3 * cells)
        up_work = (4 * (cells * (2 + taps) + cells // 4 + cells),
                   cells * (4 + cfg.post_smoothing * (a + GS_UPDATE)))
        rows.append(dict(name="strip_down", shape=[n, n], five_point=five, ok=down_ok,
                         max_abs_err=max(max_err(got_x, want_x)[0],
                                         max_err(got_rc, want_rc)[0]),
                         rel_err=max(max_err(got_x, want_x)[1], max_err(got_rc, want_rc)[1]),
                         scale=float(want_x.abs().max()), ms=ms_d, plain_ms=plain_d,
                         work=down_work))
        rows.append(dict(name="strip_up", shape=[n, n], five_point=five, ok=up_ok,
                         max_abs_err=max_err(got_up, want_up)[0],
                         rel_err=max_err(got_up, want_up)[1],
                         scale=float(want_up.abs().max()), ms=ms_u, plain_ms=plain_u,
                         work=up_work))
    return rows


def check_vcycle(dev, levels, cfg, rng, sync_ms):
    import torch

    from naviflow_tpu_torch.ops import mg

    tail = levels[2:]
    n = tail[0][1][0]
    assert mg.supports_fused(tail, cfg) and not mg.supports_fused(levels[1:], cfg)
    b = torch.as_tensor(rng.normal(size=(n, n)), dtype=torch.float32, device=dev)
    p = torch.zeros_like(b)
    got = mg.fused_vcycle(p, b, tail, cfg)
    want = mg.fused_vcycle_plain(p, b, tail, cfg)
    torch_sync()
    a, r = max_err(got, want)
    ms, plain_ms = time_pair(lambda: mg.fused_vcycle_plain(p, b, tail, cfg),
                             lambda: mg.fused_vcycle(p, b, tail, cfg))
    meta = meta_of(tail)
    bar = Barriers()
    bar.vcycle(meta, cfg)
    bar.settle()
    # tests/test_pallas.py: 1e-5 of the cycle output's scale
    return dict(name="fused_vcycle", shape=[n, n], levels=[m[0][0] for m in meta],
                ok=r < 1e-5, max_abs_err=a, rel_err=r, ms=ms, plain_ms=plain_ms,
                work=vcycle_work(meta, cfg), grid_barriers=bar.n,
                barrier_bound_ms=bar.n * sync_ms(n * n))


# ---------------------------------------------------------------------------
# the 63^2 kernels (K4, K5, K6, K7, and K3 on a vertex hierarchy)


def headline_configs(backend="auto", cycle_type="v"):
    from naviflow_tpu_torch.solvers import KrylovMomentumConfig, MultigridConfig

    mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=20, backend=backend)
    pres = MultigridConfig(tolerance=1e-2, max_cycles=6, cycle_type=cycle_type, check_every=2,
                           coarsest_sweeps=8, coarse_rebuild_every=8, backend=backend)
    return mom, pres


def cavity_case(n):
    import naviflow_tpu_torch as nt

    mesh = nt.StructuredMesh(nx=n, ny=n)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=RE)
    return mesh, fluid, nt.lid_driven_cavity(1.0)


def odd_inputs(n, dev, steps):
    """A cavity state after ``steps`` composed headline steps from rest, its
    relaxed momentum systems, and the vertex hierarchy and continuity
    right-hand side of its pressure correction (all composed)."""
    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import SIMPLEConfig, simple_solve
    from naviflow_tpu_torch.core.bc import apply_velocity_bcs
    from naviflow_tpu_torch.ops.poisson import pressure_rhs
    from naviflow_tpu_torch.ops.powerlaw import (relax_coefficients, u_momentum_coefficients,
                                                 v_momentum_coefficients)
    from naviflow_tpu_torch.solvers.momentum import solve_u_momentum, solve_v_momentum
    from naviflow_tpu_torch.solvers.multigrid import build_levels

    mesh, fluid, bc = cavity_case(n)
    mom, pres = headline_configs("composed")
    st = nt.initialize_state(mesh, bc, device=dev)
    if steps:
        st, _ = simple_solve(mesh, fluid, bc, st, SIMPLEConfig(max_iterations=steps,
                                                               tolerance=0.0),
                             momentum=mom, pressure=pres)
    kw = dict(dx=mesh.dx, dy=mesh.dy, rho=1.0, mu=1.0 / RE)
    u, v = apply_velocity_bcs(st.u, st.v, bc)
    cu = relax_coefficients(u_momentum_coefficients(u, v, st.p, **kw), u, 0.7)
    cv = relax_coefficients(v_momentum_coefficients(u, v, st.p, **kw), v, 0.7)
    u_star, d_u, _, _ = solve_u_momentum(u, v, st.p, alpha=0.7, bc=bc, cfg=mom, **kw)
    v_star, d_v, _, _ = solve_v_momentum(u, v, st.p, alpha=0.7, bc=bc, cfg=mom, **kw)
    levels = build_levels(d_u, d_v, pres, dx=mesh.dx, dy=mesh.dy, rho=1.0,
                          variant="consistent")
    b = pressure_rhs(u_star, v_star, dx=mesh.dx, dy=mesh.dy, rho=1.0, pin=False)
    return dict(u=u, v=v, cu=cu, cv=cv, levels=levels, b=b, pres=pres)


def check_bicgstab(inp, sync_ms):
    """K7 on the u and v systems, maxiter 3 and 20: 1e-4 of the field
    (tests/test_pallas.py's K7 tolerance)."""
    from naviflow_tpu_torch.ops import krylov

    rows = []
    for field in ("u", "v"):
        x0, c = inp[field], inp["c" + field]
        n = x0.numel()
        for maxiter in (3, 20):
            got = krylov.bicgstab_momentum(x0, c, tol=1e-6, maxiter=maxiter)
            with count_applies() as applies:
                want = krylov.bicgstab_momentum_plain(x0, c, tol=1e-6, maxiter=maxiter)
            torch_sync()
            iters = (applies[0] - 1) // 2
            a, r = max_err(got, want)
            ms, plain_ms = time_pair(
                lambda: krylov.bicgstab_momentum_plain(x0, c, tol=1e-6, maxiter=maxiter),
                lambda: krylov.bicgstab_momentum(x0, c, tol=1e-6, maxiter=maxiter))
            bar = Barriers()
            bar.bicgstab(iters)
            rows.append(dict(name="bicgstab_momentum", field=field, shape=list(x0.shape),
                             maxiter=maxiter, iterations=iters, ok=r < 1e-4, max_abs_err=a,
                             rel_err=r, ms=ms, plain_ms=plain_ms, work=bicgstab_work(n, iters),
                             grid_barriers=bar.n, barrier_bound_ms=bar.n * sync_ms(n),
                             main=maxiter == 20))
    return rows


def check_rap(hier, sync_ms):
    """K4 on each hierarchy: every coarse stencil entry within 1e-5 of its
    array's scale (tests/test_pallas.py's K4 tolerance)."""
    from naviflow_tpu_torch.ops import mg

    rows = []
    for n, levels in hier:
        shapes, meta = [lv[1] for lv in levels], meta_of(levels)
        fine = levels[0][0]
        got = mg.galerkin_levels(fine, shapes, True)
        want = mg.galerkin_levels_plain(fine, shapes, True)
        torch_sync()
        worst_abs = worst_rel = 0.0
        for g, w in zip(got, want):
            for name in ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw"):
                a, r = max_err(getattr(g, name), getattr(w, name))
                worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        ms, plain_ms = time_pair(lambda: mg.galerkin_levels_plain(fine, shapes, True),
                                 lambda: mg.galerkin_levels(fine, shapes, True))
        bar = Barriers()
        bar.rap(meta)
        bar.settle()
        rows.append(dict(name="galerkin_levels", shape=[n, n], levels=[s[0] for s in shapes],
                         ok=worst_rel < 1e-5, max_abs_err=worst_abs, rel_err=worst_rel, ms=ms,
                         plain_ms=plain_ms, work=rap_work(meta), grid_barriers=bar.n,
                         barrier_bound_ms=bar.n * sync_ms(shapes[1][0] * shapes[1][1]),
                         main=n == NH))
    return rows


def check_mg_solve(inp, sync_ms):
    """K5 at the headline configuration and at tolerance 1e-4 / 30 cycles:
    equal cycle counts, p within 1e-4, rel within 1e-5 (tests/test_pallas.py's
    K5 tolerances)."""
    import dataclasses

    import torch

    from naviflow_tpu_torch.ops import mg

    levels, b = inp["levels"], inp["b"]
    meta = meta_of(levels)
    rows = []
    for cfg in (inp["pres"], dataclasses.replace(inp["pres"], tolerance=1e-4, max_cycles=30)):
        p0 = torch.zeros_like(b)
        p, r, cyc, rel = mg.fused_mg_solve(p0, b, levels, cfg)
        pw, rw, cycw, relw = mg.fused_mg_solve_plain(p0, b, levels, cfg)
        torch_sync()
        a, e = max_err(p, pw)
        cycles = int(cycw)
        ok = int(cyc) == cycles and e < 1e-4 and abs(float(rel) - float(relw)) < 1e-5
        ms, plain_ms = time_pair(lambda: mg.fused_mg_solve_plain(p0, b, levels, cfg),
                                 lambda: mg.fused_mg_solve(p0, b, levels, cfg))
        bar = Barriers()
        bar.mg_solve(meta, cfg, cycles)
        rows.append(dict(name="fused_mg_solve", shape=list(b.shape), tolerance=cfg.tolerance,
                         max_cycles=cfg.max_cycles, cycles=int(cyc), cycles_plain=cycles,
                         rel=float(rel), rel_plain=float(relw), ok=ok, max_abs_err=a,
                         rel_err=e, ms=ms, plain_ms=plain_ms,
                         work=mg_solve_work(meta, cfg, cycles), grid_barriers=bar.n,
                         barrier_bound_ms=bar.n * sync_ms(b.numel()),
                         main=cfg.tolerance == inp["pres"].tolerance))
    return rows


def check_vertex_vcycle(inp, sync_ms):
    """K3 on the 63^2 -> 7^2 vertex hierarchy: 1e-5 of the cycle output."""
    import torch

    from naviflow_tpu_torch.ops import mg

    levels, b, cfg = inp["levels"], inp["b"], inp["pres"]
    meta = meta_of(levels)
    p = torch.zeros_like(b)
    got = mg.fused_vcycle(p, b, levels, cfg)
    want = mg.fused_vcycle_plain(p, b, levels, cfg)
    torch_sync()
    a, r = max_err(got, want)
    ms, plain_ms = time_pair(lambda: mg.fused_vcycle_plain(p, b, levels, cfg),
                             lambda: mg.fused_vcycle(p, b, levels, cfg))
    bar = Barriers()
    bar.vcycle(meta, cfg)
    bar.settle()
    return dict(name="fused_vcycle", shape=list(b.shape), levels=[m[0][0] for m in meta],
                vertex=True, ok=r < 1e-5, max_abs_err=a, rel_err=r, ms=ms, plain_ms=plain_ms,
                work=vcycle_work(meta, cfg), grid_barriers=bar.n,
                barrier_bound_ms=bar.n * sync_ms(b.numel()))


def check_step(dev, sync_ms):
    """K6: three chained 63^2 steps from rest and one 255^2 step; u, v, p
    within 2e-4, equal cycle counts (tests/test_pallas.py's K6 tolerances)."""
    import torch

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import SIMPLEConfig
    from naviflow_tpu_torch.ops import step

    rows = []
    for n, chain in ((NH, 3), (NH_BIG, 1)):
        mesh, _, bc = cavity_case(n)
        mom, pres = headline_configs()
        sc = SIMPLEConfig()
        assert step.supports_fused_step(n, n, sc, mom, pres, torch.float32)
        kw = dict(dx=mesh.dx, dy=mesh.dy, rho=1.0, mu=1.0 / RE, bc=bc, cfg=sc, mom_cfg=mom,
                  pres_cfg=pres)
        s = nt.initialize_state(mesh, bc, device=dev)
        u, v, p, pm = s.u, s.v, s.p, torch.zeros((), device=dev)
        worst_abs = worst_rel = 0.0
        ok = True
        for _ in range(chain):
            got = step.fused_outer_step("simple", u, v, p, (pm,), **kw)
            with count_applies() as applies:
                want = step.fused_outer_step_plain("simple", u, v, p, (pm,), **kw)
            torch_sync()
            for g, w in zip(got[:3], want[:3]):
                a, r = max_err(g, w)
                worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
                ok &= r < 2e-4
            ok &= int(got[4]) == int(want[4])
            ins = (u, v, p, pm)
            cycles, k_total = int(want[4]), (applies[0] - 2) // 2
            u, v, p, pm = want[0], want[1], want[2], want[3][0]
        u, v, p, pm = ins
        reps = REPS if n == NH else 5
        ms, plain_ms = time_pair(
            lambda: step.fused_outer_step_plain("simple", u, v, p, (pm,), **kw),
            lambda: step.fused_outer_step("simple", u, v, p, (pm,), **kw), reps=reps)
        shapes = step.step_shapes(n, n, pres)
        meta = [(shp, lvl == 0) for lvl, shp in enumerate(shapes)]
        bar = Barriers()
        bar.grid(2)
        bar.bicgstab(0)
        bar.bicgstab(0)
        bar.n += 5 * k_total
        bar.grid(2)
        bar.rap(meta)
        bar.mg_solve(meta, pres, cycles)
        bar.grid()
        rows.append(dict(name="fused_simple_step", shape=[n, n], chained_steps=chain,
                         cycles=cycles, krylov_iterations=k_total, ok=ok,
                         max_abs_err=worst_abs, rel_err=worst_rel, ms=ms, plain_ms=plain_ms,
                         work=step_work(n, meta, pres, k_total, cycles), grid_barriers=bar.n,
                         barrier_bound_ms=bar.n * sync_ms((n + 1) * n), main=n == NH))
    return rows


# ---------------------------------------------------------------------------
# main paths


def counts():
    from naviflow_tpu_torch.ops import asmcheby, krylov, mg, step, strip

    return {"fused_asmcheby_pair": asmcheby.LAUNCHES,
            "strip_down": strip.STRIP_DOWN_LAUNCHES,
            "strip_up": strip.STRIP_UP_LAUNCHES,
            "fused_vcycle": mg.LAUNCHES,
            "galerkin_levels": mg.RAP_LAUNCHES,
            "fused_mg_solve": mg.SOLVE_LAUNCHES,
            "bicgstab_momentum": krylov.LAUNCHES,
            "fused_simple_step": step.LAUNCHES}


def reset_counts():
    from naviflow_tpu_torch.ops import asmcheby, krylov, mg, step, strip

    asmcheby.LAUNCHES = 0
    strip.STRIP_DOWN_LAUNCHES = 0
    strip.STRIP_UP_LAUNCHES = 0
    mg.LAUNCHES = mg.RAP_LAUNCHES = mg.SOLVE_LAUNCHES = 0
    krylov.LAUNCHES = 0
    step.LAUNCHES = 0


def only(**nonzero):
    """The expected launch counts: the given ones, every other kernel 0."""
    return {k: nonzero.get(k, 0) for k in counts()}


def solve(dev, backend):
    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import SIMPLEConfig, simple_solve
    from naviflow_tpu_torch.solvers import ChebyshevMomentumConfig, MultigridConfig

    mesh = nt.StructuredMesh(nx=N, ny=N)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=RE)
    bc = nt.lid_driven_cavity(1.0)
    mom = ChebyshevMomentumConfig(degree=4, backend=backend)
    pres = MultigridConfig(tolerance=0.0, max_cycles=1, cycle_type="v", pre_smoothing=1,
                           post_smoothing=1, coarsest_sweeps=32, coarse_rebuild_every=8,
                           backend=backend)
    state = nt.initialize_state(mesh, bc, device=dev)  # a fresh state per solve
    torch_sync()
    t0 = time.perf_counter()
    out, diag = simple_solve(mesh, fluid, bc, state, SIMPLEConfig(max_iterations=STEPS,
                                                                  tolerance=0.0),
                             momentum=mom, pressure=pres, loop="fused")
    torch_sync()
    return out, diag, (time.perf_counter() - t0) * 1e3 / STEPS


def run_slice(dev):
    import torch

    solve(dev, "auto")  # warm-up (allocator, library load)
    _, diag_c1, ms_c1 = solve(dev, "composed")
    reset_counts()
    state_k, diag_k, ms_k1 = solve(dev, "auto")
    launches = counts()
    _, _, ms_k2 = solve(dev, "auto")
    _, diag_c2, ms_c2 = solve(dev, "composed")
    hist = diag_k.total_res_history.double()
    finite = bool(torch.isfinite(hist).all()) and all(
        bool(torch.isfinite(getattr(state_k, k)).all()) for k in ("u", "v", "p"))
    falling = bool(hist[-1] < hist[0])
    res_k = float(diag_k.final_residual)
    res_c = float(diag_c1.final_residual)
    gap = abs(res_k - res_c) / res_c
    want = only(fused_asmcheby_pair=STEPS, strip_down=2 * STEPS, strip_up=2 * STEPS,
                fused_vcycle=STEPS)
    row = dict(phase="slice", grid=N, re=RE, steps=STEPS, launches=launches,
               launches_expected=want, residual_kernel=res_k, residual_composed=res_c,
               residual_gap=gap, residual_first=float(hist[0]), residual_last=float(hist[-1]),
               finite=finite, falling=falling,
               ms_per_step_kernel=[ms_k1, ms_k2], ms_per_step_composed=[ms_c1, ms_c2],
               composed_repeat_residual=float(diag_c2.final_residual))
    row["ok"] = launches == want and finite and falling and gap <= 0.05
    return row


def solve_headline(dev, backend, tol, *, cycle_type="v", max_iterations=4000):
    """One 63^2 solve from rest; returns (state, diag, wall seconds)."""
    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import SIMPLEConfig, simple_solve

    mesh, fluid, bc = cavity_case(NH)
    mom, pres = headline_configs(backend, cycle_type)
    state = nt.initialize_state(mesh, bc, device=dev)
    torch_sync()
    t0 = time.perf_counter()
    out, diag = simple_solve(mesh, fluid, bc, state,
                             SIMPLEConfig(max_iterations=max_iterations, tolerance=tol),
                             momentum=mom, pressure=pres)
    torch_sync()
    return out, diag, time.perf_counter() - t0


def profile_headline(dev, steps=20):
    """torch.profiler over ``steps`` kernel-path steps: device busy time,
    the window, and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    solve_headline(dev, "auto", 0.0, max_iterations=steps)  # warm-up
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve_headline(dev, "auto", 0.0, max_iterations=steps)
            window_ms = (time.perf_counter() - t0) * 1e3
        by_name = {}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            if t and t > 0:
                by_name[e.key] = (t / 1e3, e.count)
        busy = sum(t for t, _ in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        return dict(steps=steps, window_ms=window_ms, device_busy_ms=busy,
                    idle_share=1.0 - busy / window_ms if window_ms > 0 else None,
                    top=[dict(name=k[:80], ms=t, calls=c) for k, (t, c) in top])
    except Exception as e:  # the profiler is untried on this machine
        torch_sync()
        return dict(steps=steps, error=f"not measured: {e!r}"[:300])


def run_headline(dev):
    from naviflow_tpu_torch.postprocessing.validation import infinity_norm_error

    mesh, _, _ = cavity_case(NH)
    solve_headline(dev, "auto", 1e-3, max_iterations=4)  # warm-up
    runs, ok = {}, True
    for tol in (1e-3, 1e-5):
        for backend in ("auto", "composed"):
            reset_counts()
            state, diag, wall = solve_headline(dev, backend, tol)
            launches = counts()
            it = int(diag.iterations)
            want = (only(fused_simple_step=it, galerkin_levels=1) if backend == "auto"
                    else only())
            err = infinity_norm_error(state.u, state.v, mesh, int(RE))
            runs[f"{backend}_{tol:g}"] = dict(
                iterations=it, converged=bool(diag.converged),
                final_residual=float(diag.final_residual), wall_s=wall,
                ms_per_step=wall * 1e3 / max(it, 1), ghia_infinity_error=err,
                launches=launches, launches_expected=want, launches_ok=launches == want)
            ok &= launches == want and bool(diag.converged)
        k, c = runs[f"auto_{tol:g}"], runs[f"composed_{tol:g}"]
        ok &= abs(k["iterations"] - c["iterations"]) <= max(2, 0.02 * c["iterations"])
    ok &= runs["auto_1e-05"]["ghia_infinity_error"] < 0.10
    return dict(phase="headline", grid=NH, re=RE, runs=runs,
                profile=profile_headline(dev), ok=ok)


def run_fmg(dev):
    import torch

    reset_counts()
    state_k, diag_k, wall_k = solve_headline(dev, "auto", 0.0, cycle_type="fmg",
                                             max_iterations=FMG_STEPS)
    launches = counts()
    _, diag_c, wall_c = solve_headline(dev, "composed", 0.0, cycle_type="fmg",
                                       max_iterations=FMG_STEPS)
    hist = diag_k.total_res_history.double()
    finite = bool(torch.isfinite(hist).all()) and all(
        bool(torch.isfinite(getattr(state_k, k)).all()) for k in ("u", "v", "p"))
    falling = bool(hist[-1] < hist[0])
    res_k, res_c = float(diag_k.final_residual), float(diag_c.final_residual)
    gap = abs(res_k - res_c) / res_c
    refreshes = math.ceil(FMG_STEPS / 8)
    want = only(bicgstab_momentum=2 * FMG_STEPS, fused_mg_solve=FMG_STEPS,
                galerkin_levels=1 + refreshes)
    return dict(phase="fmg", grid=NH, steps=FMG_STEPS, launches=launches,
                launches_expected=want, residual_kernel=res_k, residual_composed=res_c,
                residual_gap=gap, residual_first=float(hist[0]), residual_last=float(hist[-1]),
                finite=finite, falling=falling, ms_per_step_kernel=wall_k * 1e3 / FMG_STEPS,
                ms_per_step_composed=wall_c * 1e3 / FMG_STEPS,
                ok=launches == want and finite and falling and gap <= 0.05)


# ---------------------------------------------------------------------------


SOURCES = {
    "fused_asmcheby_pair": ("naviflow_tpu_torch/csrc/asmcheby.cu",
                            "naviflow_tpu/ops/pallas_asmcheby.py:303", "slice"),
    "strip_down": ("naviflow_tpu_torch/csrc/strip.cu", "naviflow_tpu/ops/pallas_strip.py:304",
                   "slice"),
    "strip_up": ("naviflow_tpu_torch/csrc/strip.cu", "naviflow_tpu/ops/pallas_strip.py:339",
                 "slice"),
    "fused_vcycle": ("naviflow_tpu_torch/csrc/mg.cu", "naviflow_tpu/ops/pallas_mg.py:479",
                     "slice"),
    "galerkin_levels": ("naviflow_tpu_torch/csrc/mg.cu", "naviflow_tpu/ops/pallas_mg.py:445",
                        "headline"),
    "fused_mg_solve": ("naviflow_tpu_torch/csrc/mg.cu", "naviflow_tpu/ops/pallas_mg.py:512",
                       "fmg"),
    "bicgstab_momentum": ("naviflow_tpu_torch/csrc/krylov.cu",
                          "naviflow_tpu/ops/pallas_krylov.py:142", "fmg"),
    "fused_simple_step": ("naviflow_tpu_torch/csrc/step.cu",
                          "naviflow_tpu/ops/pallas_step.py:364", "headline"),
}


def kernels_line(rows, paths):
    """One entry per kernel.  The time, error and work are those of its
    main-path shape (K2: both strip levels of one step, summed; K7: the u
    and v solves at maxiter 20, averaged); the launches are those of the
    path that runs it (K1-K3 the 1024^2 slice, K4 and K6 the headline to
    1e-3, K5 and K7 the FMG run), with every path's count beside them."""
    out = []
    for name, (src, replaces, path) in SOURCES.items():
        mine = [r for r in rows if r["name"] == name and r.get("main", True)
                and not r.get("vertex")]
        if name in ("strip_down", "strip_up"):
            agg, k = sum, 1
        else:
            agg, k = sum, len(mine)
        ms = agg(r["ms"] for r in mine) / k
        plain_ms = agg(r["plain_ms"] for r in mine) / k
        nbytes = agg(r["work"][0] for r in mine) / k
        flops = agg(r["work"][1] for r in mine) / k
        b_ms, b_by = bound(nbytes, flops)
        entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                     launches=paths[path][name], max_abs_err=max(r["max_abs_err"] for r in mine),
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     launches_by_path={p: c[name] for p, c in paths.items()},
                     bytes=nbytes, flops=flops)
        if all("barrier_bound_ms" in r for r in mine):
            entry["grid_barriers"] = agg(r["grid_barriers"] for r in mine) / k
            entry["barrier_bound_ms"] = agg(r["barrier_bound_ms"] for r in mine) / k
        out.append(entry)
    return out


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    try:
        import naviflow_tpu_torch  # noqa: F401
        from naviflow_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout of the repository: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    card = nvidia_smi()
    emit(dict(phase="device", nvidia_smi=card, torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              name=torch.cuda.get_device_name(0), count=torch.cuda.device_count()))

    t0 = time.perf_counter()
    _cuda.library()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds=_cuda.build_seconds, library=_cuda.library_path().name))

    sync_cache = {}

    def sync_ms(cells):
        blocks = -(-cells // 256)
        if blocks not in sync_cache:
            sync_cache[blocks] = grid_sync_ms(cells, dev)
        return sync_cache[blocks]

    rows = [check_asmcheby(dev)]
    levels, cfg, rng = fine_levels(dev)
    rows += check_strips(dev, levels, cfg, rng)
    rows.append(check_vcycle(dev, levels, cfg, rng, sync_ms))
    del levels
    inp = odd_inputs(NH, dev, steps=5)
    big = odd_inputs(NH_BIG, dev, steps=0)
    rows += check_bicgstab(inp, sync_ms)
    rows += check_rap([(NH, inp["levels"]), (NH_BIG, big["levels"])], sync_ms)
    rows += check_mg_solve(inp, sync_ms)
    rows.append(check_vertex_vcycle(inp, sync_ms))
    rows += check_step(dev, sync_ms)
    del big
    for row in rows:
        emit(dict(phase="kernel", **{k: v for k, v in row.items() if k != "work"},
                  bytes=row["work"][0], flops=row["work"][1]))
    emit(dict(phase="grid_barrier", ms_by_blocks={str(k): v for k, v in sync_cache.items()}))
    if not all(r["ok"] for r in rows):
        print("chip_smoke: a kernel disagrees with its plain version", file=sys.stderr)
        return 1

    paths = {}
    for phase, fn in (("slice", run_slice), ("headline", run_headline), ("fmg", run_fmg)):
        row = fn(dev)
        emit(row)
        if not row["ok"]:
            print(f"chip_smoke: the {phase} run failed its checks", file=sys.stderr)
            return 1
        paths[phase] = (row["launches"] if phase != "headline"
                        else row["runs"]["auto_0.001"]["launches"])

    kernels = kernels_line(rows, paths)
    unlaunched = [k["name"] for k in kernels if k["launches"] < 1]
    if unlaunched:
        print(f"chip_smoke: never launched on their path: {unlaunched}", file=sys.stderr)
        return 1
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
