#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``naviflow_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero with no
result line:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the kernel build: ``nvcc`` compiles ``naviflow_tpu_torch/csrc/*.cu`` for
   sm_90a from the checkout;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the 1024^2 main path gives it, with its tolerance and both times
   (CUDA events, turns plain / kernel / kernel / plain);
4. the main path: ``simple_solve`` at 1024^2, Re=100, with the bench's
   large-grid configuration (Chebyshev momentum of degree 4, one fixed
   V-cycle with 1/1 smoothing, 32 coarsest sweeps, coarse rebuild every 8
   steps) for 40 outer steps, with the kernels, and the same run with
   ``backend='composed'``; the kernel launch counts of the kernel run must
   be K1 = 40, strip_down = 80, strip_up = 80, K3 = 40, its residual
   history finite and falling, and its final residual within 5% of the
   composed run's (the kernel run's momentum bounds lag one step).

Then a JSON line with every kernel's launches, error and times, the card's
name and power limit, and, last, ``{"ok": true, "device": {...}}``.  Needs
no network and no JAX; there is no CPU path.
"""

import json
import subprocess
import sys
import time

N = 1024  # grid of the main path (bench.py large-grid row)
STEPS = 40
RE = 100.0
SEED = 0
REPS = 20  # timed launches per kernel measurement


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


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
    return dict(name="fused_asmcheby_pair", shape=[N, N], degree=degree, ok=ok,
                max_abs_err=worst_abs, rel_err=errs, ms=ms, plain_ms=plain_ms)


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
        rows.append(dict(name="strip_down", shape=[n, n], five_point=five, ok=down_ok,
                         max_abs_err=max(max_err(got_x, want_x)[0],
                                         max_err(got_rc, want_rc)[0]),
                         rel_err=max(max_err(got_x, want_x)[1], max_err(got_rc, want_rc)[1]),
                         scale=float(want_x.abs().max()), ms=ms_d, plain_ms=plain_d))
        rows.append(dict(name="strip_up", shape=[n, n], five_point=five, ok=up_ok,
                         max_abs_err=max_err(got_up, want_up)[0],
                         rel_err=max_err(got_up, want_up)[1],
                         scale=float(want_up.abs().max()), ms=ms_u, plain_ms=plain_u))
    return rows


def check_vcycle(dev, levels, cfg, rng):
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
    # tests/test_pallas.py: 1e-5 of the cycle output's scale
    return dict(name="fused_vcycle", shape=[n, n], levels=[t[1][0] for t in tail],
                ok=r < 1e-5, max_abs_err=a, rel_err=r, ms=ms, plain_ms=plain_ms)


def torch_sync():
    import torch

    torch.cuda.synchronize()


def counts():
    from naviflow_tpu_torch.ops import asmcheby, mg, strip

    return {"fused_asmcheby_pair": asmcheby.LAUNCHES,
            "strip_down": strip.STRIP_DOWN_LAUNCHES,
            "strip_up": strip.STRIP_UP_LAUNCHES,
            "fused_vcycle": mg.LAUNCHES}


def reset_counts():
    from naviflow_tpu_torch.ops import asmcheby, mg, strip

    asmcheby.LAUNCHES = 0
    strip.STRIP_DOWN_LAUNCHES = 0
    strip.STRIP_UP_LAUNCHES = 0
    mg.LAUNCHES = 0


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
    want = {"fused_asmcheby_pair": STEPS, "strip_down": 2 * STEPS,
            "strip_up": 2 * STEPS, "fused_vcycle": STEPS}
    row = dict(phase="slice", grid=N, re=RE, steps=STEPS, launches=launches,
               launches_expected=want, residual_kernel=res_k, residual_composed=res_c,
               residual_gap=gap, residual_first=float(hist[0]), residual_last=float(hist[-1]),
               finite=finite, falling=falling,
               ms_per_step_kernel=[ms_k1, ms_k2], ms_per_step_composed=[ms_c1, ms_c2],
               composed_repeat_residual=float(diag_c2.final_residual))
    row["ok"] = launches == want and finite and falling and gap <= 0.05
    return row


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

    rows = [check_asmcheby(dev)]
    levels, cfg, rng = fine_levels(dev)
    rows += check_strips(dev, levels, cfg, rng)
    rows.append(check_vcycle(dev, levels, cfg, rng))
    for row in rows:
        emit(dict(phase="kernel", **row))
    if not all(r["ok"] for r in rows):
        print("chip_smoke: a kernel disagrees with its plain version", file=sys.stderr)
        return 1

    sl = run_slice(dev)
    emit(sl)
    if not sl["ok"]:
        print("chip_smoke: the main-path run failed its checks", file=sys.stderr)
        return 1

    sources = {
        "fused_asmcheby_pair": ("naviflow_tpu_torch/csrc/asmcheby.cu",
                                "naviflow_tpu/ops/pallas_asmcheby.py:303"),
        "strip_down": ("naviflow_tpu_torch/csrc/strip.cu", "naviflow_tpu/ops/pallas_strip.py:304"),
        "strip_up": ("naviflow_tpu_torch/csrc/strip.cu", "naviflow_tpu/ops/pallas_strip.py:339"),
        "fused_vcycle": ("naviflow_tpu_torch/csrc/mg.cu", "naviflow_tpu/ops/pallas_mg.py:479"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        mine = [r for r in rows if r["name"] == name]
        # per outer step: the strip kernels run once per peeled level
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=sl["launches"][name],
                            max_abs_err=max(r["max_abs_err"] for r in mine),
                            ms=sum(r["ms"] for r in mine),
                            plain_ms=sum(r["plain_ms"] for r in mine)))
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
