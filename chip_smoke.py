#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``naviflow_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero with no
result line:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. the kernel build: ``nvcc`` compiles ``naviflow_tpu_torch/csrc/*.cu`` for
   sm_90a from the checkout, one process per source; ptxas's registers and
   spills of K1's, K2's, K6's, K3's, K5's, K7's and K9's kernels (each
   strip_up instance's, K4's and K11's by name), K1's resident blocks an SM at
   degree 4 and strip_down's and strip_up's at each (points, sweeps), the
   thread-block cluster size each K6 body, K3, K4, K5 and K7 launch with,
   how many clusters of each batched K6 body fit at once at 16 and 8 CTAs
   (``step.max_active_clusters``), and one cluster barrier's time at each
   size (``nf_cluster_sync_probe``);
3. each kernel against its plain PyTorch version on the card, with the
   tolerance of the JAX package's test of that kernel and both times (CUDA
   events, turns plain / kernel / kernel / plain): K1, K2 and K3 at the
   shapes the 1024^2 path gives them, and K1 again at 4096^2 with the
   bounds the lagged carry gives steps 1 and 2; K7 on the u and v systems
   of a 63^2 cavity state (maxiter 3 and 20) and of a 255^2 one (maxiter
   20); K4 on 63^2 and 255^2 vertex hierarchies; K5 on the 63^2 hierarchy
   at the headline configuration and at tolerance 1e-4 / 30 cycles, and on
   a 255^2 vertex and a 256^2 cell-centred hierarchy at the headline
   configuration; K6 over 3 chained 63^2 steps from rest
   and one 255^2 step; K6's batched entry at 63^2 (3 cases, 2 chained
   steps) and 255^2 (4 cases, 1 step), each case also bit-equal to its
   single launch, and a frozen case that must come back unchanged; the
   batched K7 (the u and v systems), K5 and K4 at 63^2, 3 cases with their
   own viscosities and hierarchies (``check_case_axis``), each case
   bit-equal to its single launch, the batched plain version within the
   kernel's tolerance, a frozen case as specified; the batched K1
   (1024^2, degree 4), K2a and K2b (the 1024^2 five-point and 512^2
   nine-point levels) and K3 (the 256^2 -> 4^2 tail) at B = 3, each case
   with its own Re 100 / 400 / 1000 state, viscosity, bounds and hierarchy
   (``check_large_case_axis``), the same checks; K3 on
   the 63^2 -> 7^2 vertex hierarchy; K8 at 2048^2
   (plain, with the Gershgorin maxima, and with each Poisson fold); K9 on
   the u and v systems of a 2048^2 cavity state (degree 4); K6's simplec,
   piso and simpler bodies over 3 chained 63^2 steps from rest; K10a/b at
   the 4096^2 plane shapes (1/1 smoothing) and at 1024^2 (2/2); the
   batched K8 (2048^2, with the maxima and with the consistent fold), K9
   (the u and v systems of a 2048^2 state, degree 4, each case's own
   interval scalars) and K10a / K10b (planes 4096 x 2048) at B = 3, each
   case with its own Re 100 / 400 / 1000 state (``check_assembly_case_axis``),
   each case bit-equal to its single launch, the batched plain version
   within the single kernel's tolerance, a frozen case as specified; K11a at
   63^2 (1 and 3 sweeps), 256^2 (1, 3 and 6: two launches), 48 x 96,
   255 x 257, 1024 x 64 and 64 x 1024 (3), K11b at 63^2, 256^2, 48 x 96 and
   255 x 257 with a cuSPARSE SpMV of the same operator and the device time
   of an empty launch (``launch_floor_ms``) beside it.  Every kernel's
   CUDA-event time, its device time (``device_ms``: events around launches
   queued behind a device-side sleep) and the host's time per call; beside
   them the cluster-barrier bound (K3-K7; K7's cooperative
   kernel on the 255^2 fields: the grid-barrier bound); then
   K6's phase split (``nf_fused_outer_step_phases``)
   for each body over 20 chained 63^2 steps, K3's
   (``nf_fused_vcycle_phases``) on the 256^2 tail and the 63^2 vertex
   hierarchy over 20 calls, and K1's (``nf_asmcheby_pair_phases``: its
   assembly, Chebyshev steps, residual / d / writes and pressure operator)
   at 1024^2 and 4096^2 over 20 calls;
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
   rebuild every 8 steps) to 1e-3 and to 1e-5 with the kernels, and to
   1e-3 composed: every kernel-run step is one K6 launch, K4 runs once (the
   lagged carry's setup rebuild) and nothing else launches; kernel outer
   iterations within 2% or 2 of the composed run's (1e-3) and of the JAX
   package's on the CPU (56 / 568); Ghia infinity error below 0.10 at 1e-5; the device's idle share over 20 kernel steps
   (``profile_window``: busy time from CUDA events around each step
   replayed behind a device-side sleep, the profiler's sum beside it);
6. the FMG run: the same case with ``cycle_type='fmg'`` (which the K6 gate
   refuses) for 12 steps (``FMG_STEPS``): launches K7 = 24, K5 = 12, K4 = 1
   + 2 refreshes, nothing else; residual finite, falling, within 5% of the
   composed run; the step's split (``fmg_split``: host and device ms per
   step of K7, K5, K4 and the composed FMG bootstrap, the bootstrap's from
   4 replayed calls, and the rest of the host's time) and the device's
   idle share over 4 steps (``profile_window``);
7. the 2048^2 large-grid path: SIMPLEC (20 steps), PISO, SIMPLER and SIMPLE
   with the bench's BiCGSTAB momentum (10 steps each) at Re=100 with the
   bench's large-grid configuration, with the kernels and composed: launches
   K8 once per momentum solve, K9 once per field and Chebyshev solve, a K2
   pair per peeled level and one K3 per pressure solve, K1 never; histories
   finite and falling (SIMPLER's: falling first, then it turns, as in the
   JAX package); the residual within 5% of the composed run's at every
   step;
8. SIMPLEC, PISO and SIMPLER at 63^2 with the headline configuration to
   1e-3, with the kernels and composed: one K6 launch per step and K4 once;
   iterations within 2% or 2 (SIMPLEC: 5%) of the composed run's and of the
   JAX package's on the CPU (131 / 39 / 56);
9. the 4096^2 plane layout: ``simple_solve`` at 4096^2, Re=100, with the
   bench's large-grid configuration and ``fine_layout='plane'`` for 6 steps
   (bench.py's large_grid_3), with the kernels, composed, with composed
   momentum but the pressure kernels, and with no kernel but K1's lagged
   carry (K1 swapped for its plain version), then in the interleaved layout
   with the kernels: exact launches (K10a = K10b = K3 = K1 = 6, a K2 pair
   per level the strip gate admits below the plane level); histories
   finite; at every step the all-kernel run within 1e-3 of the lagged plain
   run and the pressure-kernel run within 1e-3 of the composed run (the
   all-kernel run's gap to the composed run, and the lagged plain run's,
   are reported); both layouts' final residuals and ms per step;
10. the grid-sequenced continuation (bench.py's ``BENCH_MODE=seq``):
    ``grid_sequence_solve`` at 1024^2, Re=1000, to 1e-5 over the ladder
    32 -> 1024 with BiCGSTAB momentum (1e-6, <= 25 iterations), V-cycles to
    1e-2 (<= 8, checked every 2, 32 coarsest sweeps, coarse rebuild every 8)
    and ``loop='chunked:300'``: every level converges, the Ghia infinity
    error is below 0.10, K7, K8, K5, K2 and K3 launch and no other kernel;
    each level's iterations, seconds, ms per step and launches; the device's
    idle share over 4 fine-level steps; then the 128 -> 32 ladder, 20 steps a
    level, with the kernels and composed: each level's final residual within
    5% (the largest per-step gap reported);
11. MGCG at 1024^2, Re=1000, 10 steps from rest (CG to 1e-5 preconditioned
    by one V-cycle, 2/2 smoothing, 32 coarsest sweeps), with the kernels and
    composed: exact launches (K8 a step; a K2 pair per peeled level and one
    K3 per preconditioner application); the CG iterations of each step;
    final residual within 5% of the composed run's;
12. the solver zoo at 64^2 and 63^2, Re=100: the pressure solvers (20
    steps) CG, BiCGSTAB and GMRES with and without Jacobi preconditioning,
    Jacobi and direct pressure, multigrid with the Jacobi, Chebyshev and
    bfloat16 smoothers, injection restriction and (63^2) rediscretized
    coarsening with cubic prolongation, and the Gauss-Seidel multigrid
    baseline under the 'fused', 'host' and 'chunked:7' loops; the momentum
    solvers (20 steps, Gauss-Seidel multigrid pressure) red-black GS, GMRES
    and IDR(s), and (63^2) QUICK through GMRES: each card run within 1e-3
    of the same run on the CPU in float64; no K2, K3, K5 or K6 launch off the
    Gauss-Seidel multigrid, at least one on it; then SIMPLE at 1024^2 with
    red-black GS momentum and bench.py's large-grid pressure, 10 steps:
    K8 a step, a K2 pair per peeled level and one K3 a step, every step
    within 1e-3 of the same run with composed pressure;
13. the 9-point QUICK path (``run_quick``): ``benchmarks/scale_runs.py``'s
    511^2 QUICK configuration at Re=1000, 40 steps from rest, with the
    kernels and composed: launches exactly what the gates admit (K4 a step,
    K3 a V-cycle; none of K1, K6, K7, K8, K9, which refuse 9-point
    momentum); every step's residual and the u, v, p fields within 1e-3 of
    composed, LUDS in place of QUICK failing that; ms a step, idle share
    over 4 steps;
    then 63^2 Re=100 QUICK to 1e-5 (BiCGSTAB momentum to 1e-9, <= 150
    iterations; the headline's V-cycles: K4 at the carry's builds, K5 a
    step), Ghia below 0.10, and LUDS to 1e-3;
14. the distributed solver (``run_distributed``) on a 1x1 mesh over NCCL
    in one process: bench.py's 64^2 parity check of SIMPLE and SIMPLEC
    against the single-device solves (max |du|, |dv| < 1e-4), then 1024^2
    SIMPLE, 10 steps, Chebyshev momentum and MGCG pressure, held to the
    single-device run of the same algorithm at 1e-3 (CG totals within
    10%), a control (CG to 1e-2) failing; ms and CG iterations a step,
    collectives a step by kind, and no kernel launch;
15. the object API (``run_api``): the reference's driver pattern at 63^2
    Re=100 with its constructors mapped onto the headline configuration,
    ``SimpleSolver`` to 1e-5 with ``track_infinity_norm`` on the chunked
    loop, bit-equal to ``simple_solve``, 568 iterations, K6 a step and K4
    once, Ghia below 0.10; ``SimplecSolver``, ``PisoSolver`` and
    ``SimplerSolver`` to 1e-3 in the algorithms63 phase's iterations;
16. case batching (``run_batch``): ``batched_cavity_solve``, the lockstep
    loop, at 63^2 (Re 100 / 400 / 1000, the 8-case sweep Re 100-1000 and Re
    100 alone) and at 255^2 (4 cases) to 1e-3: each case bit-equal to its
    single solve, one batched K6 launch a lockstep step (the largest
    iteration count), no single K6 launch and K4 once a batch; beside each
    batch the same cases one after another; ms a lockstep step at B = 1, 3,
    8; the idle share over the 8-case loop; the batched K6's max active
    clusters; then ``batch_fmg`` (``run_batch_fmg``): the FMG headline
    configuration, which K6's gate refuses, for at most 12 lockstep steps
    to 1e-3 over Re 100 alone, Re 100 / 400 / 1000 and the 8-case sweep:
    the vmapped branch (``torch.func.vmap`` of the single step), batched K7
    = 2 x the lockstep steps, batched K5 = the steps, batched K4 = the
    refreshes, single K4 = 1 and nothing else; each case's iterations equal
    its single solve's, its fields and every history step bit-equal or
    within 1e-3; ms a lockstep step at B = 1, 3, 8 beside the same cases
    one after another; the vmapped step's host split
    (``fmg_split_batched``); the idle share over 2 lockstep steps of the
    8-case batch; then ``batch_large`` (``run_batch_large``): ``bench.py``'s
    large-grid SIMPLE (the 1024^2 slice's configuration) batched over Re
    100 / 400 / 1000 for 10 lockstep steps, the vmapped branch's even arm:
    batched K1 = 10, K2a = K2b = 20, K3 = 10 and nothing else; each case
    held to its single solve bit for bit or within 1e-4 (fields and every
    history step), a case held to its neighbour's single solve failing
    that; whether the batched mean, norm and max round as one case's; ms a
    lockstep step at B = 1 and 3 beside the single solves; the idle share
    over 2 lockstep steps; and the even 256^2 8-case sweep, 10 steps, one
    batched K5 a step (K5 takes that whole hierarchy), each case held the
    same way; then ``batch_assembly`` (``run_batch_assembly``): SIMPLEC,
    PISO and SIMPLER at 2048^2 with the large-grid configuration (6
    lockstep steps), ``large_grid_3`` in the plane layout at 4096^2 (3) and
    SIMPLE with red-black GS momentum at 1024^2 (6), each over Re 100 / 400
    / 1000 through the even arm's K8, K9 and K10: launches exact (the
    batched K8, K9, K10a, K10b, K1, K2a, K2b and K3 of ``run_large_grid`` /
    ``run_plane`` a step, nothing else, no per-case step), each case held
    to its single solve bit for bit or within 1e-4 with equal iterations
    (SIMPLEC: equal alpha_p backoffs), the neighbour-Re control failing
    that, ms a lockstep step at B = 1 and 3 beside the single solves, the
    idle share over 2 lockstep steps at 2048^2 and 4096^2;
17. Newton-Krylov (``run_newton``): ``benchmarks/scale_runs.py``'s QUICK
    pipeline at 255^2 Re=1000 (a SIMPLE warm start, then ``newton_solve``
    to 1e-5): converged, Ghia below 0.10, K4 once a Newton step and K5 once
    a preconditioner application; its captured tangent program against
    ``torch.func.jvp``; the idle share over one Newton step of one GMRES
    restart cycle; then the same pipeline at 63^2 against the port's CPU
    float64 run (computed in a spawned process while the earlier phases
    run): Newton iterations within one, u, v, p within 1e-3, and the
    power-law residual in place of QUICK failing that;
18. the command line (``run_cli``): ``naviflow_tpu_torch.cli.main``
    in-process on the card, its JSON line read back: (a) ``run`` with the
    CLI's defaults at 63^2 Re=100 to 1e-5, bit-equal to the direct
    ``simple_solve`` with ``_make_solvers``' configs and its launches (K6 a
    step, as the K6 gate admits those configs), iterations within 2% or 2
    of the JAX package's CLI on the CPU (568), Ghia below 0.10; (b) its
    ``--save`` to .npz and .vtk read back equal; (c) ``--checkpoint-dir``
    (``chunked:100``, 300 iterations), then ``--resume`` to 600: each kept
    checkpoint bit-equal to the direct chunked run's state at its
    iteration; (d) ``sweep`` at Re 100 / 400 / 1000 to 1e-3 with and
    without ``--vmap``: the rows equal to each other and to a direct
    ``batched_cavity_solve``, ``--vmap`` one batched K6 launch a lockstep
    step; (e) ``run --sequence`` at 255^2 to 1e-4:
    converged, Ghia below 0.10, a direct ``grid_sequence_solve``'s
    launches; (f) ``run --newton`` on 63^2 QUICK Re=1000 after 200 SIMPLE
    steps: Newton converged, K4 a Newton step and K5 a preconditioner
    application; (g) ``run --distributed`` on 64^2 on one rank: equal to
    the direct call, no kernel; (h) ``utils.mg_debug.debug_vcycle``
    bit-equal to the composed cycle on the 63^2 vertex, 256^2 and 1024^2
    cell-centred hierarchies and within K3's / K2's tolerances of the
    kernel cycle; (i) the ``operator_sanity`` and ``cavity_basic``
    examples' ``run(args)``.

Then a JSON line with each phase's seconds, a JSON line with every
kernel's launches, error, times and bound (K2: each level's too, and the
launches a step), the card's name and power limit, and, last, ``{"ok":
true, "device": {...}}``.  Needs no network and
no JAX; there is no CPU path.  With ``--ab TAG`` it runs one side of an A/B
between two trees instead (``ab_side``: K1, K2a, K2b, K3, K7, K5, K4, K6's
phase split, K8, K9, K10a, K10b, K11a and K11b, or those ``--kernels``
names; ``--save DIR`` keeps K1's, K2a's, K2b's, K3's, K4's, K5's, K7's,
K8's, K9's, K10's and K11's outputs), and with ``--ab-compare
DIR A B`` it compares two saved sides output by output.
"""

import contextlib
import ctypes
import dataclasses
import json
import math
import re
import subprocess
import sys
import time

N = 1024  # grid of the large-grid path (bench.py large-grid row)
STEPS = 40
NH = 63  # the headline grid (bench.py main)
NH_BIG = 255  # the largest grid the K6 gate admits
FMG_STEPS = 12  # the FMG run's steps, and the FMG batch's at most
NL = 2048  # the large-grid algorithms' grid (bench.py large-grid row)
# outer steps of each large-grid run, and of the 63^2 algorithm runs' JAX
# counts to 1e-3 (the JAX package in float32 on the CPU, bench.py's
# headline configuration)
LARGE_STEPS = {"simplec": 20, "piso": 10, "simpler": 10, "simple_bicgstab": 10}
JAX_ITERATIONS_63 = {"simplec": 131, "piso": 39, "simpler": 56}
# the same package's SIMPLE headline counts to 1e-3 and 1e-5: bench.py's
# record BENCH_r05.json (outer_iterations 56, validated.outer_iterations
# 568; its fused and composed runs alike), which the JAX package in float32
# on the CPU also gives; the composed run here goes to 1e-3 only, its 568
# steps to 1e-5 took 84-113 s of the script
JAX_ITERATIONS_HEADLINE = {1e-3: 56, 1e-5: 568}
NP = 4096  # the colour-plane layout's grid (bench.py large_grid_3)
PLANE_STEPS = 6
# the grid-sequenced continuation (bench.py _bench_sequenced, BENCH_MODE=seq)
NS = 1024
RE_SEQ = 1000.0
SEQ_CHECK_GRID = 128  # the kernels-against-composed ladder 128 -> 32
SEQ_CHECK_STEPS = 20
PROFILE_STEPS = 4
SEQ_PROFILE_LEVELS = (32, 128)  # idle share over their first steps
# The path-level comparisons' limit on relative gaps (final residuals, a
# residual history's steps, the u, v, p fields) and on the relative gap of
# the inner-iteration totals where a rounding moves each step's count
# (BiCGSTAB pressure, MGCG at 1024^2); each lies between the sound runs'
# largest reading and a control's (PERF.md §6).
GAP_LIMIT = 1e-3
ITER_TOTAL_LIMIT = 0.10
MGCG_STEPS = 10
SOLVER_GRIDS = (64, 63)
SOLVER_STEPS = 20  # the pressure zoo's steps (at 10, 63^2 BiCGSTAB pressure's rounding
# still moves the fields past the limit: its trajectories meet again later)
MOMENTUM_STEPS = 20  # the momentum zoo's
RE = 100.0
# the quick phase: benchmarks/scale_runs.py's 511^2 QUICK configuration at
# its schedule's first Reynolds number (per_re(1000): alpha_p 0.25 * 0.6)
NQ, RE_Q, QUICK_STEPS, QUICK_ALPHA_P = 511, 1000.0, 40, 0.15
# the distributed phase: bench.py's 64^2 parity check, then 1024^2
NB, BENCH_DIST_STEPS = 64, 5
ND, DIST_STEPS = 1024, 10
BENCH_DIST_LIMIT = 1e-4  # bench.py _distributed_check's limit on max |du|, |dv|
RBGS_LARGE_STEPS = 10  # the solvers phase's 1024^2 red-black GS momentum run
# the newton phase: benchmarks/scale_runs.py's QUICK Newton pipeline
# (run_newton_511) at Re=1000 on 255^2, and at 63^2 against the port's CPU
# float64 run of the same pipeline, which takes minutes of one CPU core (the
# preconditioner's composed multigrid), so a spawned process computes it
# while the card runs the earlier phases (``start_newton_reference``)
NN, NN_SMALL, RE_N = 255, 63, 1000.0
NEWTON_WARM_STEPS = {NN: 300, NN_SMALL: 200}  # SIMPLE warm-start steps from rest
NEWTON_REFERENCE_TIMEOUT = 900.0  # seconds the newton phase waits for it
NEWTON_ITER_SLACK = 1  # Newton iterations of the card's 63^2 run: the reference's +-1
BATCH_RE = (100.0, 400.0, 1000.0)  # the batch phase's cases (63^2, headline config)
BATCH_RE8 = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 800.0, 1000.0)  # its 8-case sweep
BATCH_RE_BIG = (100.0, 400.0, 700.0, 1000.0)  # its 4 cases at NH_BIG
BATCH_TOLERANCE, BATCH_MAX_IT = 1e-3, 3000
# the kernel phase's batched K6 rows: (grid, the cases' Reynolds numbers,
# chained steps from rest)
BATCH_KERNEL_CASES = ((NH, (100.0, 400.0, 1000.0), 2), (NH_BIG, (100.0, 400.0, 700.0, 1000.0), 1))
# the batch phase's batch_large run: bench.py's large-grid SIMPLE at N^2 over
# BATCH_RE, its lockstep steps, its limit on each case's relative gap to its
# single solve where not bit-equal, and the even sweep's grid (BATCH_RE8)
BATCH_LARGE_STEPS, BATCH_LARGE_LIMIT, BATCH_LARGE_SWEEP_GRID = 10, 1e-4, 256
# the batch phase's batch_assembly runs: lockstep steps at 2048^2 and 1024^2,
# and at 4096^2 in the plane layout
BATCH_ASM_STEPS, BATCH_PLANE_STEPS = 6, 3
# the batch_loops phase (BiCGSTAB momentum and tolerance-driven multigrid
# through ops/while_loop.py): lockstep steps from rest; K7's grid-form rows'
# grids (the 256^2 fields are the command line's default sweep's) and the
# cooperative grid's largest field the gate admits (bit-equality alone)
BATCH_LOOP_STEPS = 6
GRID_CASE_GRIDS, GRID_CASE_LARGEST = (256, 255), 511
ALGORITHMS63_ITERATIONS = {}  # the algorithms63 phase's kernel runs (name -> iterations)
SEED = 0
REPS = 10  # timed launches per kernel measurement (20 before the large batch's rows)
PLAIN_REPS = 1  # timed calls per turn of a kernel's plain version (4 before)
SLEEP_CYCLES = 60_000_000  # device_ms's head start: ~30 ms of the SM clock

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
# float32 FLOP/s outside the tensor cores.  bound_ms of a kernel is the
# larger of its bytes over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Operation counts per element used in the bounds: a 5- / 9-point stencil
# apply, a compensated (Dot2) product-and-accumulate, a Gauss-Seidel update
# beyond its stencil apply.
APPLY5, APPLY9, DOT2, GS_UPDATE = 9, 17, 25, 3


def _json_scalar(x):
    """numpy scalars (a comparison's ``numpy.bool``, an ``np.float64``) as
    Python ones."""
    if hasattr(x, "item"):
        return x.item()
    raise TypeError(f"Object of type {type(x).__name__} is not JSON serializable")


def emit(obj):
    print(json.dumps(obj, default=_json_scalar), flush=True)


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


def time_ms(fn, reps=REPS):
    """ms per call of ``fn`` (CUDA events over ``reps`` calls, warmed up)."""
    import torch

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


def time_pair(plain, kernel, reps=REPS):
    """ms per call of each, in turns plain, kernel, kernel, plain, and the
    kernel's device time per call (``device_ms``).  The plain version runs
    ``PLAIN_REPS`` calls a turn: it is host-bound and up to 1.3 s a call
    (the batched K6 bodies), where the kernel takes 0.01-1 ms."""
    p1, k1 = time_ms(plain, PLAIN_REPS), time_ms(kernel, reps)
    k2, p2 = time_ms(kernel, reps), time_ms(plain, PLAIN_REPS)
    return (k1 + k2) / 2, (p1 + p2) / 2, device_ms(kernel, reps)


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


def barrier_ms(entry, first, dev):
    """ms of one barrier of a probe entry (``ip``: ``first``, then the
    barrier count): 1 and 2001 barriers, the difference over 2000."""
    import torch

    from naviflow_tpu_torch.ops import _cuda

    probe = getattr(_cuda.library(), entry)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(syncs, reps=5):
        ip = (ctypes.c_int * 2)(first, syncs)
        ptrs = (ctypes.c_longlong * 1)(0)
        fp = (ctypes.c_float * 1)(0.0)
        _cuda.check(probe(ptrs, ip, fp, stream), entry)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            _cuda.check(probe(ptrs, ip, fp, stream), entry)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    return (run(2001) - run(1)) / 2000


def blocks_per_sm(entry, *args):
    """The resident blocks an SM a kernel's occupancy query reports (an
    ``nf_*_blocks_per_sm`` entry: its arguments, then the count out)."""
    from naviflow_tpu_torch.ops import _cuda

    out = ctypes.c_int(0)
    _cuda.check(getattr(_cuda.library(), entry)(*args, ctypes.byref(out)), entry)
    return out.value


def ptxas_kernels(src, kernel):
    """ptxas's registers and spills of each instance of ``kernel`` in
    ``src``'s build log, by ``kernel<template arguments>``."""
    from naviflow_tpu_torch.ops import _cuda

    out, name = {}, None
    for line in _cuda.build_log.get(src, "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: |$)",
                      line)
        if m:
            name = None
            # the mangled identifier, its length first (kernel, not kernel_batched)
            if f"{len(kernel)}{kernel}" in m.group(1):  # a template's instance: kernel<arguments>
                k = re.search(kernel + r"I((?:L[a-z]+\d+E)+)E", m.group(1))
                args = re.findall(r"L[a-z]+(\d+)E", k.group(1)) if k else []
                name = f"{kernel}<{','.join(args)}>" if args else kernel
            continue
        if name is None:
            continue
        regs = re.search(r"Used (\d+) registers", line)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if regs:
            out.setdefault(name, {})["registers"] = int(regs.group(1))
        if spills:
            out.setdefault(name, {}).update(spill_stores=int(spills.group(1)),
                                            spill_loads=int(spills.group(2)))
    return out


def grid_sync_ms(cells, dev):
    """ms of one grid-wide barrier in a cooperative launch sized for
    ``cells`` cells (nf_grid_sync_probe)."""
    return barrier_ms("nf_grid_sync_probe", cells, dev)


def cluster_sync_ms(size, dev):
    """ms of one cluster barrier in one cluster of ``size`` CTAs of K6's
    width (nf_cluster_sync_probe)."""
    return barrier_ms("nf_cluster_sync_probe", size, dev)


def k6_barriers(algo, cfg, meta, pres, k_total, cycles, psolves):
    """The cluster barriers of one K6 step (csrc/step.cuh over
    csrc/cluster.cuh), pass by pass: one after every pass over a global
    level and every reduction; the coarse part of a V-cycle (the levels of
    <= 1,024 cells, in rank 0 alone) ends in one.  ``k_total`` Krylov
    iterations and ``cycles`` V-cycles over the step's ``psolves``
    pressure solves."""
    cells = [a * b for (a, b), _ in meta]
    colors = [2 if five else 4 for _, five in meta]
    L = len(cells)
    Ls = next((lvl for lvl in range(1, L) if cells[lvl] <= 1024), L)
    top = min(Ls, L - 1)
    vcycle = sum((pres.pre_smoothing + pres.post_smoothing) * colors[lvl] + 2
                 for lvl in range(top))
    vcycle += 1 if Ls < L else pres.coarsest_sweeps * colors[-1]
    # per solve: ||b||, the mean and its subtraction, the final residual;
    # per check one residual norm
    mean = 2 if cfg.poisson_variant != "reference" else 0
    mg = psolves * (2 + mean) + cycles * vcycle + cycles // pres.check_every
    pressure = psolves * (1 + (L - 1)) + mg  # RHS and operator, one RAP pass a level
    update_p = 1 + int(cfg.overwrite_boundary_pressure)

    def pair(krylov_solves=2, jacobi_sweeps=None):  # assembly, the solves, BCs on u*, v*
        if jacobi_sweeps is not None:
            return 1 + 2 * max(jacobi_sweeps, 1) + 1
        return 1 + 3 * krylov_solves + 1

    n = 2 + 1 + pair() + 1  # start and end, BCs, the predictor, its residual norms
    n += 5 * k_total + pressure
    if algo == "simple":
        n += update_p + 1 + 1
    elif algo == "simplec":
        n += int(cfg.smooth_p_prime) + update_p + 1 + 1
    elif algo == "piso":
        sweeps = None if cfg.corrector == "exact" else cfg.corrector_sweeps
        n += cfg.n_corrections * (update_p + 1) + 1
        n += (cfg.n_corrections - 1) * (1 + pair(jacobi_sweeps=sweeps))
    else:  # simpler
        n += update_p + pair() + update_p + 1 + 1
    return n


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


def step_work(nx, meta, cfg, k_total, cycles, pairs=1, psolves=1):
    """One outer step with ``pairs`` BiCGSTAB momentum pairs (the first with
    its compensated residuals) and ``psolves`` pressure solves."""
    nu, nv, np_ = (nx + 1) * nx, nx * (nx + 1), nx * nx
    faces = nu + nv
    byts = 4 * (3 * faces + 3 * np_)  # u, v, p in; u', v', p', r_u, r_v, r_p out
    # assembly per face and pair; compensated residuals once; corrections
    # per face and solve; continuity, operator and norm per cell and solve
    flops = (faces * (pairs * 70 + 6 * (2 + 6 + 17) + 2 * DOT2 + psolves * 8)
             + psolves * np_ * (20 + DOT2 + 3))
    flops += (2 * pairs * (APPLY5 + 3 * DOT2 + 1) * max(nu, nv)
              + k_total * max(nu, nv) * (2 * APPLY5 + 5 * DOT2 + 12))
    flops += psolves * rap_work(meta)[1] + mg_solve_work(meta, cfg, cycles)[1]
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


@contextlib.contextmanager
def plain_k1():
    """The SIMPLE path's K1 call (``solvers/momentum.solve_momentum_pair``)
    swapped for K1's plain version: the lagged carry and its bounds stay as
    they are, and no kernel runs for the momentum."""
    from naviflow_tpu_torch.ops import asmcheby
    from naviflow_tpu_torch.solvers import momentum

    real = momentum.fused_asmcheby_pair
    momentum.fused_asmcheby_pair = asmcheby.fused_asmcheby_pair_plain
    try:
        yield
    finally:
        momentum.fused_asmcheby_pair = real


# ---------------------------------------------------------------------------
# the 1024^2 kernels (K1, K2, K3)


def cavity_fields(n, dev, seed=SEED):
    """A lid-driven-cavity state plus seeded noise, BCs applied."""
    import numpy as np
    import torch

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.core.bc import apply_velocity_bcs

    rng = np.random.default_rng(seed)
    mesh = nt.StructuredMesh(nx=n, ny=n)
    bc = nt.lid_driven_cavity(1.0)
    st = nt.initialize_state(mesh, bc, device=dev)

    def noise(shape, scale):
        return torch.as_tensor(scale * rng.normal(size=shape), dtype=torch.float32, device=dev)

    u, v = apply_velocity_bcs(st.u + noise(st.u.shape, 0.1), st.v + noise(st.v.shape, 0.1), bc)
    p = noise(st.p.shape, 1.0)
    return u, v, p, dict(dx=mesh.dx, dy=mesh.dy, rho=1.0, mu=1.0 / RE)


def k1_args(kw, rho_u, rho_v):
    """K1's keyword arguments on the main path (degree 4, alpha 0.7, the
    consistent operator) with the bounds of the raw maxima rho_u, rho_v."""
    from naviflow_tpu_torch.solvers.momentum import _bounds_from_rho

    return dict(alpha=0.7, degree=4, bounds_u=_bounds_from_rho(rho_u, 1.05),
                bounds_v=_bounds_from_rho(rho_v, 1.05), poisson_variant="consistent", **kw)


def asmcheby_current(dev, n):
    """A noisy n^2 cavity state (``cavity_fields``) and K1's arguments with
    the bounds of the state's own assembly."""
    from naviflow_tpu_torch.ops import asmcheby
    from naviflow_tpu_torch.ops.powerlaw import relax_coefficients, u_momentum_coefficients
    from naviflow_tpu_torch.ops.powerlaw import v_momentum_coefficients
    from naviflow_tpu_torch.solvers.momentum import _u_interior_mask, _v_interior_mask

    u, v, p, kw = cavity_fields(n, dev)
    rho_u = asmcheby._masked_ratio_max(
        relax_coefficients(u_momentum_coefficients(u, v, p, **kw), u, 0.7),
        _u_interior_mask(u.shape, device=dev))
    rho_v = asmcheby._masked_ratio_max(
        relax_coefficients(v_momentum_coefficients(u, v, p, **kw), v, 0.7),
        _v_interior_mask(v.shape, device=dev))
    return (u, v, p), k1_args(kw, rho_u, rho_v)


def check_asmcheby(dev, n=N, lagged=False):
    """K1 against its plain version on a noisy n^2 cavity state, with the
    bounds of the state's own assembly; with ``lagged``, with the bounds the
    SIMPLE path's lagged carry gives its first two steps instead: the clamp
    ceiling rho = 0.999 on the state (step 1), then the state's maxima on
    the plain K1's output from it (step 2).  One row per call."""
    import torch

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.core.bc import apply_velocity_bcs
    from naviflow_tpu_torch.ops import asmcheby

    degree = 4
    if lagged:
        u, v, p, kw = cavity_fields(n, dev)
        ceiling = torch.full((), 0.999, dtype=torch.float32, device=dev)
        first = k1_args(kw, ceiling, ceiling)
        out = asmcheby.fused_asmcheby_pair_plain(u, v, p, **first)
        u2, v2 = apply_velocity_bcs(out[0], out[2], nt.lid_driven_cavity(1.0))
        cases = [("lagged_step1", (u, v, p), first),
                 ("lagged_step2", (u2, v2, p), k1_args(kw, out[7], out[8]))]
    else:
        cases = [("current", *asmcheby_current(dev, n))]
    rows = []
    for bounds, fields, a in cases:
        got = asmcheby.fused_asmcheby_pair(*fields, **a)
        want = asmcheby.fused_asmcheby_pair_plain(*fields, **a)
        torch_sync()
        # tolerances of tests/test_pallas_asmcheby.py, relative to each
        # output's scale
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
            e_abs, e_rel = max_err(g, w)
            errs[name] = e_rel
            worst_abs = max(worst_abs, e_abs)
            ok &= e_rel < tol
        def kernel():
            asmcheby.fused_asmcheby_pair(*fields, **a)

        ms, plain_ms, dev_ms = time_pair(
            lambda: asmcheby.fused_asmcheby_pair_plain(*fields, **a), kernel)
        faces = 2 * n * (n + 1)  # both fields' faces
        # u, v, p in; x*, r and d of both fields, the 5 pc arrays, the 2 maxima out
        nbytes = 4 * (faces + n * n + 3 * faces + 5 * n * n + 2)
        flops = faces * (70 + degree * (APPLY5 + 8) + 10) + 10 * n * n
        rows.append(dict(name="fused_asmcheby_pair", shape=[n, n], degree=degree, bounds=bounds,
                         ok=ok, max_abs_err=worst_abs, rel_err=errs, ms=ms, plain_ms=plain_ms,
                         device_ms=dev_ms, host_ms=host_ms(kernel), main=n == N,
                         work=(nbytes, flops)))
    return rows


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


def strip_close(g, w):
    """tests/test_pallas_strip.py's and test_pallas_plane.py's rtol 1e-5,
    atol 1e-4, on fields of magnitude ~100: the atol is those tests' noise
    floor, so it scales with the field, 1e-4 * max|want| / 100 (the 512^2
    Galerkin level's fields here are ~10x larger)."""
    import torch

    atol = max(1e-4, 1e-6 * float(w.abs().max()))
    return bool(torch.allclose(g, w, rtol=1e-5, atol=atol))


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

        down_ok = strip_close(got_x, want_x) and strip_close(got_rc, want_rc)
        up_ok = strip_close(got_up, want_up)
        def down():
            strip.strip_down(p, b, st, cfg, five)

        ms_d, plain_d, dev_d = time_pair(lambda: strip.strip_down_plain(p, b, st, cfg, five),
                                         down)
        def up():
            strip.strip_up(want_x, b, st, ec, cfg, five)

        ms_u, plain_u, dev_u = time_pair(
            lambda: strip.strip_up_plain(want_x, b, st, ec, cfg, five), up)
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
                         device_ms=dev_d, host_ms=host_ms(down), work=down_work))
        rows.append(dict(name="strip_up", shape=[n, n], five_point=five, ok=up_ok,
                         max_abs_err=max_err(got_up, want_up)[0],
                         rel_err=max_err(got_up, want_up)[1],
                         scale=float(want_up.abs().max()), ms=ms_u, plain_ms=plain_u,
                         device_ms=dev_u, host_ms=host_ms(up), work=up_work))
    return rows


def vcycle_barriers(meta, cfg):
    """The cluster barriers of one V-cycle of K3 and K5 (csrc/vcycle.cuh
    ``nf_vc_passes``): per level in global memory (level 0 and the levels
    of more than 1,024 cells) one per colour pass of its pre- and
    post-smoothing, one after the restriction below it and one after the
    prolongation into it; then one after rank 0's shared-memory part where
    there are such levels, else one per colour pass of the coarsest
    sweeps."""
    from naviflow_tpu_torch.ops import mg

    colors = [2 if five else 4 for _, five in meta]
    first, _ = mg.vcycle_layout([shp for shp, _ in meta])
    top = min(first, len(meta) - 1)
    n = sum((cfg.pre_smoothing + cfg.post_smoothing) * colors[lvl] + 2 for lvl in range(top))
    return n + (1 if first < len(meta) else cfg.coarsest_sweeps * colors[-1])


def k3_barriers(meta, cfg):
    """One K3 launch: the barrier after the input copy, then the cycle's."""
    return 1 + vcycle_barriers(meta, cfg)


def k5_barriers(meta, cfg, cycles, mean_normalize=True):
    """One K5 launch (``nf_vc_mg_solve``): the first barrier (its wait
    before the first reduction) and ||b||'s reduction; the cycles' and one
    reduction per check; the mean's reduction and the barrier after its
    subtraction; the last barrier."""
    checks = cycles // cfg.check_every
    return 2 + cycles * vcycle_barriers(meta, cfg) + checks + 2 * int(mean_normalize) + 1


def k7_barriers(iterations):
    """One launch of K7's band kernel (csrc/krylov.cu): the first barrier
    and the setup's reduction, three reductions an iteration, the last
    barrier."""
    return 3 + 3 * iterations


def vcycle_row(p, b, levels, cfg, cl_ms, **extra):
    """K3 on one hierarchy against its plain version: 1e-5 of the cycle
    output's scale (tests/test_pallas.py), the times, the host's time per
    call and the cluster-barrier bound."""
    from naviflow_tpu_torch.ops import mg

    got = mg.fused_vcycle(p, b, levels, cfg)
    want = mg.fused_vcycle_plain(p, b, levels, cfg)
    torch_sync()
    a, r = max_err(got, want)

    def kernel():
        mg.fused_vcycle(p, b, levels, cfg)

    ms, plain_ms, dev_ms = time_pair(lambda: mg.fused_vcycle_plain(p, b, levels, cfg), kernel)
    meta = meta_of(levels)
    bar = k3_barriers(meta, cfg)
    return dict(name="fused_vcycle", shape=list(b.shape), levels=[m[0][0] for m in meta],
                ok=r < 1e-5, max_abs_err=a, rel_err=r, ms=ms, plain_ms=plain_ms,
                device_ms=dev_ms, host_ms=host_ms(kernel), work=vcycle_work(meta, cfg),
                cluster_barriers=bar, barrier_bound_ms=bar * cl_ms, **extra)


def check_vcycle(dev, levels, cfg, rng, cl_ms):
    """K3 on the 256^2 -> 4^2 tail of the 1024^2 hierarchy; returns the row
    and the tail's inputs (for ``k3_phases``)."""
    import torch

    from naviflow_tpu_torch.ops import mg

    tail = levels[2:]
    n = tail[0][1][0]
    assert mg.supports_fused(tail, cfg) and not mg.supports_fused(levels[1:], cfg)
    b = torch.as_tensor(rng.normal(size=(n, n)), dtype=torch.float32, device=dev)
    return vcycle_row(torch.zeros_like(b), b, tail, cfg, cl_ms), (tail, cfg, b)


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
    return dict(u=u, v=v, p=st.p, cu=cu, cv=cv, levels=levels, b=b, pres=pres, mesh=mesh,
                mom=mom)


def check_bicgstab(inputs, cl_ms, sync_ms):
    """K7 on the u and v systems of each ``(n, odd_inputs)``, maxiter 3 and
    20 at 63^2 and 20 above: 1e-4 of the field (tests/test_pallas.py's K7
    tolerance).  ``cl_ms``: one cluster barrier's time at K7's size (the
    band kernel's bound); ``sync_ms(cells)``: one grid barrier's (the
    cooperative grid kernel's, larger fields)."""
    from naviflow_tpu_torch.ops import krylov

    rows = []
    for n, inp in inputs:
        for field in ("u", "v"):
            x0, c = inp[field], inp["c" + field]
            for maxiter in ((3, 20) if n == NH else (20,)):
                def kernel(x0=x0, c=c, maxiter=maxiter):
                    return krylov.bicgstab_momentum(x0, c, tol=1e-6, maxiter=maxiter)

                def plain(x0=x0, c=c, maxiter=maxiter):
                    return krylov.bicgstab_momentum_plain(x0, c, tol=1e-6, maxiter=maxiter)

                got = kernel()
                with count_applies() as applies:
                    want = plain()
                torch_sync()
                iters = (applies[0] - 1) // 2
                a, r = max_err(got, want)
                ms, plain_ms, dev_ms = time_pair(plain, kernel)
                _, band, smem = krylov.band_layout(tuple(x0.shape),
                                                   krylov.cluster_size(x0.device))
                # the cooperative grid form has its own row (its main path:
                # the sequenced ladder's 256^2 level)
                row = dict(name="bicgstab_momentum" if band else "bicgstab_momentum_grid",
                           field=field, shape=list(x0.shape),
                           maxiter=maxiter, iterations=iters,
                           kernel="cluster" if band else "grid", smem_bytes=smem,
                           ok=r < 1e-4, max_abs_err=a, rel_err=r, ms=ms, plain_ms=plain_ms,
                           device_ms=dev_ms, host_ms=host_ms(kernel),
                           work=bicgstab_work(x0.numel(), iters),
                           main=not band or (n == NH and maxiter == 20))
                if band:
                    bar = k7_barriers(iters)
                    row.update(cluster_barriers=bar, barrier_bound_ms=bar * cl_ms)
                else:
                    bar = 3 + 5 * iters  # krylov.cuh: 3 in the setup, 5 an iteration
                    row.update(grid_barriers=bar, barrier_bound_ms=bar * sync_ms(x0.numel()))
                rows.append(row)
    return rows


def check_rap(hier, cl_ms):
    """K4 on each hierarchy: every coarse stencil entry within 1e-5 of its
    array's scale (tests/test_pallas.py's K4 tolerance).  ``cl_ms``: one
    cluster barrier's time at K4's size; one barrier a coarse level."""
    from naviflow_tpu_torch.ops import mg

    rows = []
    for n, levels in hier:
        shapes, meta = [lv[1] for lv in levels], meta_of(levels)
        fine = levels[0][0]

        def kernel(fine=fine, shapes=shapes):
            return mg.galerkin_levels(fine, shapes, True)

        got = kernel()
        want = mg.galerkin_levels_plain(fine, shapes, True)
        torch_sync()
        worst_abs = worst_rel = 0.0
        for g, w in zip(got, want):
            for name in ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw"):
                a, r = max_err(getattr(g, name), getattr(w, name))
                worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        ms, plain_ms, dev_ms = time_pair(lambda: mg.galerkin_levels_plain(fine, shapes, True),
                                         kernel)
        bar = len(shapes) - 1
        rows.append(dict(name="galerkin_levels", shape=[n, n], levels=[s[0] for s in shapes],
                         ok=worst_rel < 1e-5, max_abs_err=worst_abs, rel_err=worst_rel, ms=ms,
                         plain_ms=plain_ms, device_ms=dev_ms, host_ms=host_ms(kernel),
                         work=rap_work(meta), cluster_barriers=bar,
                         barrier_bound_ms=bar * cl_ms, main=n == NH))
    return rows


def even_hierarchy(n, dev, cfg):
    """A cell-centred n^2 hierarchy (5-point level 0, composed Galerkin
    levels) from seeded d-fields, and a seeded zero-mean right-hand side."""
    import numpy as np
    import torch

    from naviflow_tpu_torch.solvers.multigrid import build_levels

    rng = np.random.default_rng(SEED + 2)
    d_u = torch.as_tensor(rng.uniform(0.5, 1.5, (n + 1, n)), dtype=torch.float32, device=dev)
    d_v = torch.as_tensor(rng.uniform(0.5, 1.5, (n, n + 1)), dtype=torch.float32, device=dev)
    levels = build_levels(d_u, d_v, cfg, dx=1.0 / n, dy=1.0 / n, rho=1.0, variant="consistent")
    b = torch.as_tensor(rng.normal(size=(n, n)), dtype=torch.float32, device=dev)
    return levels, b - b.mean()


def check_mg_solve(cases, cl_ms):
    """K5 on each ``(label, levels, b, configs)``: equal cycle counts, p
    within 1e-4, rel within 1e-5 (tests/test_pallas.py's K5 tolerances).
    ``cl_ms``: one cluster barrier's time at K5's size."""
    import torch

    from naviflow_tpu_torch.ops import mg

    rows = []
    for label, levels, b, cfgs in cases:
        meta = meta_of(levels)
        for cfg in cfgs:
            p0 = torch.zeros_like(b)

            def kernel(cfg=cfg, p0=p0):
                return mg.fused_mg_solve(p0, b, levels, cfg)

            p, r, cyc, rel = kernel()
            pw, rw, cycw, relw = mg.fused_mg_solve_plain(p0, b, levels, cfg)
            torch_sync()
            a, e = max_err(p, pw)
            cycles = int(cycw)
            ok = int(cyc) == cycles and e < 1e-4 and abs(float(rel) - float(relw)) < 1e-5
            ms, plain_ms, dev_ms = time_pair(
                lambda cfg=cfg, p0=p0: mg.fused_mg_solve_plain(p0, b, levels, cfg), kernel)
            bar = k5_barriers(meta, cfg, cycles)
            rows.append(dict(name="fused_mg_solve", hierarchy=label, shape=list(b.shape),
                             levels=[m[0][0] for m in meta], tolerance=cfg.tolerance,
                             max_cycles=cfg.max_cycles, cycles=int(cyc), cycles_plain=cycles,
                             rel=float(rel), rel_plain=float(relw), ok=ok, max_abs_err=a,
                             rel_err=e, ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                             host_ms=host_ms(kernel), work=mg_solve_work(meta, cfg, cycles),
                             cluster_barriers=bar, barrier_bound_ms=bar * cl_ms,
                             main=label == "vertex63" and cfg is cfgs[0]))
    return rows


def check_vertex_vcycle(inp, cl_ms):
    """K3 on the 63^2 -> 7^2 vertex hierarchy: 1e-5 of the cycle output."""
    import torch

    b = inp["b"]
    return vcycle_row(torch.zeros_like(b), b, inp["levels"], inp["pres"], cl_ms, vertex=True)


def host_ms(fn, reps=REPS):
    """The host's time per call of ``fn``: the host clock over ``reps``
    back-to-back calls, no synchronise inside (a launch's enqueue)."""
    fn()
    torch_sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch_sync()
    return t


def check_step(dev, cl_ms):
    """K6: three chained 63^2 steps from rest and one 255^2 step; u, v, p
    within 2e-4, equal cycle counts (tests/test_pallas.py's K6 tolerances).
    ``cl_ms``: one cluster barrier's time (``cluster_sync_ms``)."""
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

        def kernel():
            step.fused_outer_step("simple", u, v, p, (pm,), **kw)

        ms, plain_ms, dev_ms = time_pair(
            lambda: step.fused_outer_step_plain("simple", u, v, p, (pm,), **kw), kernel,
            reps=reps)
        shapes = step.step_shapes(n, n, pres)
        meta = [(shp, lvl == 0) for lvl, shp in enumerate(shapes)]
        bar = k6_barriers("simple", sc, meta, pres, k_total, cycles, 1)
        rows.append(dict(name="fused_simple_step", shape=[n, n], chained_steps=chain,
                         cycles=cycles, krylov_iterations=k_total, ok=ok,
                         max_abs_err=worst_abs, rel_err=worst_rel, ms=ms, plain_ms=plain_ms,
                         device_ms=dev_ms, host_ms=host_ms(kernel, reps),
                         work=step_work(n, meta, pres, k_total, cycles), cluster_barriers=bar,
                         barrier_bound_ms=bar * cl_ms, main=n == NH))
    return rows


def check_step_batched(dev, cl_ms, max_clusters):
    """K6's batched entry (one cluster a case): at 63^2 B = 3 over two
    chained steps from rest and at 255^2 B = 4 over one, Re as
    ``BATCH_KERNEL_CASES`` give them: every case within K6's tolerances of
    the plain version (u, v, p within 2e-4, equal cycle counts) and bit-equal
    to its single ``fused_outer_step`` launch in every output; then the last
    step's inputs again with case 1 frozen (held: that step's results),
    which must come back with its inputs and held results and leave the
    other cases' outputs unchanged.  The bound: the cases' summed work
    (each case's own Krylov iterations and cycles), and ceil(B /
    ``max_clusters``) waves of the slowest case's barrier bound."""
    import torch

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import SIMPLEConfig
    from naviflow_tpu_torch.ops import step

    rows = []
    for n, res, chain in BATCH_KERNEL_CASES:
        mesh, _, bc = cavity_case(n)
        mom, pres = headline_configs()
        sc = SIMPLEConfig()
        cases, mus = len(res), [1.0 / re for re in res]
        kw = dict(dx=mesh.dx, dy=mesh.dy, rho=1.0, bc=bc, cfg=sc, mom_cfg=mom, pres_cfg=pres)
        s = nt.initialize_state(mesh, bc, device=dev)
        u, v, p = (torch.stack([x] * cases) for x in (s.u, s.v, s.p))
        pm = torch.zeros((cases, 1), device=dev)
        active = torch.ones(cases, dtype=torch.bool, device=dev)
        worst_abs = worst_rel = 0.0
        ok = bit_equal = True
        for _ in range(chain):
            got = step.fused_outer_step_batched("simple", u, v, p, pm, active, mu=mus, **kw)
            work, cycles, krylov, bars = [0, 0], [], [], []
            for b in range(cases):
                one = step.fused_outer_step("simple", u[b], v[b], p[b], (pm[b, 0],), mu=mus[b],
                                            **kw)
                with count_applies() as applies:
                    want = step.fused_outer_step_plain("simple", u[b], v[b], p[b], (pm[b, 0],),
                                                       mu=mus[b], **kw)
                torch_sync()
                for g, w in zip(got[:3], want[:3]):
                    a, r = max_err(g[b], w)
                    worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
                    ok &= r < 2e-4
                ok &= int(got[4][b]) == int(want[4])
                bit_equal &= (all(torch.equal(g[b], o) for g, o in
                                  zip(got[:3] + got[5:], one[:3] + one[5:]))
                              and torch.equal(got[3][b], torch.stack(list(one[3])))
                              and int(got[4][b]) == int(one[4]))
                cycles.append(int(want[4]))
                krylov.append((applies[0] - 2) // 2)
                shapes = step.step_shapes(n, n, pres)
                meta = [(shp, lvl == 0) for lvl, shp in enumerate(shapes)]
                w_b = step_work(n, meta, pres, krylov[-1], cycles[-1])
                work = [work[0] + w_b[0], work[1] + w_b[1]]
                bars.append(k6_barriers("simple", sc, meta, pres, krylov[-1], cycles[-1], 1))
            ins = (u, v, p, pm)
            u, v, p, pm = got[0], got[1], got[2], got[3][:, :1]
        u, v, p, pm = ins
        frozen = active.clone()
        frozen[1] = False
        fz = step.fused_outer_step_batched("simple", u, v, p, pm, frozen, mu=mus,
                                           held=(got[3], got[4], got[5], got[6], got[7]), **kw)
        torch_sync()
        frozen_ok = (all(torch.equal(a[1], x[1]) for a, x in zip(fz[:3], (u, v, p)))
                     and torch.equal(fz[3][1, :1], pm[1])
                     and torch.equal(fz[3][1, 1:], got[3][1, 1:])
                     and int(fz[4][1]) == int(got[4][1])
                     and all(torch.equal(a[1], g[1]) for a, g in zip(fz[5:], got[5:]))
                     and all(torch.equal(a[b], g[b]) for a, g in zip(fz, got)
                             for b in range(cases) if b != 1))
        reps = REPS if n == NH else 5

        def kernel():
            step.fused_outer_step_batched("simple", u, v, p, pm, active, mu=mus, **kw)

        ms, plain_ms, dev_ms = time_pair(
            lambda: step.fused_outer_step_batched_plain("simple", u, v, p, pm, active, mu=mus,
                                                        **kw), kernel, reps=reps)
        waves = -(-cases // max_clusters)
        rows.append(dict(name="fused_outer_step_batched", shape=[n, n], cases=cases,
                         reynolds=list(res), chained_steps=chain, cycles=cycles,
                         krylov_iterations=krylov, ok=ok and bit_equal and frozen_ok,
                         bit_equal_to_single=bit_equal, frozen_case_ok=frozen_ok,
                         max_abs_err=worst_abs, rel_err=worst_rel, ms=ms, plain_ms=plain_ms,
                         device_ms=dev_ms, host_ms=host_ms(kernel, reps), work=tuple(work),
                         max_active_clusters=max_clusters, waves=waves,
                         cluster_barriers=max(bars), barrier_bound_ms=waves * max(bars) * cl_ms,
                         main=n == NH))
    return rows


def case_inputs(inp, res):
    """The kernel phase's 63^2 state (``odd_inputs``) with the viscosities
    of ``res``: each case's relaxed u and v systems, its vertex hierarchy
    from its own d-fields (K4's levels) and a seeded zero-mean right-hand
    side, stacked with a leading case axis; and each case's own."""
    import numpy as np
    import torch

    from naviflow_tpu_torch.ops.powerlaw import (d_coefficient, relax_coefficients,
                                                 u_momentum_coefficients,
                                                 v_momentum_coefficients)
    from naviflow_tpu_torch.ops.stencil import StencilCoeffs
    from naviflow_tpu_torch.ops.stencil9 import Stencil9
    from naviflow_tpu_torch.solvers.multigrid import build_levels

    mesh, u, v, p = inp["mesh"], inp["u"], inp["v"], inp["p"]
    rng = np.random.default_rng(SEED + 3)
    cases = []
    for re_ in res:
        kw = dict(dx=mesh.dx, dy=mesh.dy, rho=1.0, mu=1.0 / re_)
        cu = relax_coefficients(u_momentum_coefficients(u, v, p, **kw), u, 0.7)
        cv = relax_coefficients(v_momentum_coefficients(u, v, p, **kw), v, 0.7)
        levels = build_levels(d_coefficient(cu.a_p, mesh.dy, is_u=True),
                              d_coefficient(cv.a_p, mesh.dx, is_u=False), inp["pres"],
                              dx=mesh.dx, dy=mesh.dy, rho=1.0, variant="consistent")
        b = torch.as_tensor(rng.normal(size=p.shape), dtype=torch.float32, device=p.device)
        cases.append(dict(cu=cu, cv=cv, levels=levels, b=b - b.mean()))

    def stack_c(key):
        return StencilCoeffs(*(torch.stack([getattr(c[key], f) for c in cases])
                               for f in ("a_e", "a_w", "a_n", "a_s", "a_p", "src")))

    levels = [(Stencil9(*(torch.stack([getattr(c["levels"][lvl][0], f) for c in cases])
                          for f in ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw"))),
               shp, five, lam) for lvl, (_, shp, five, lam) in enumerate(cases[0]["levels"])]
    return dict(u=torch.stack([u] * len(res)), v=torch.stack([v] * len(res)),
                cu=stack_c("cu"), cv=stack_c("cv"), levels=levels,
                b=torch.stack([c["b"] for c in cases]), cases=cases)


def case_axis_row(name, kernel, plain, rows_extra, cases, size, cl_ms, kernel_id, work,
                  barriers, reps=REPS):
    """One batched kernel row: times (plain batched, kernel batched in
    turns), host ms, max active clusters of its cluster size and the waves
    ``cases`` take, the cases' summed work and the slowest case's barrier
    bound times the waves."""
    from naviflow_tpu_torch.ops import _cuda

    ms, plain_ms, dev_ms = time_pair(plain, kernel, reps=reps)
    fit = _cuda.case_max_clusters(kernel_id, size)
    waves = -(-cases // fit)
    return dict(name=name, cases=cases, ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                host_ms=host_ms(kernel, reps), work=work, cluster_size=size,
                max_active_clusters=fit, waves=waves, cluster_barriers=barriers,
                barrier_bound_ms=waves * barriers * cl_ms, **rows_extra)


def check_case_axis(inp, sizes, res=BATCH_RE):
    """The batched K7, K5 and K4 (one cluster a case) at 63^2, B = 3 (Re
    ``res``, each case's own systems and hierarchy, ``case_inputs``): every
    case bit-equal to its single launch in every output (each single
    launch's device ms beside the batched launch's); the batched plain
    version within the kernel's tolerances (K7 1e-4 of the field, K5 equal
    cycles, p within 1e-4 and rel within 1e-5, K4 1e-5 of each array); a
    frozen case returns its frozen outputs (K7 x0; K5 p0, zero r, 0
    cycles, rel 0; K4 zero stencils) and leaves the other cases' bits
    alone.  ``sizes``: per kernel (cluster size, one cluster barrier's
    ms)."""
    import torch

    from naviflow_tpu_torch.ops import krylov, mg
    from naviflow_tpu_torch.ops.stencil import StencilCoeffs
    from naviflow_tpu_torch.ops.stencil9 import Stencil9

    ci = case_inputs(inp, res)
    B, dev = len(res), inp["u"].device
    rows = []
    # K7: the u and v systems, maxiter 20
    for field in ("u", "v"):
        x0, c = ci[field], ci["c" + field]

        def kernel(x0=x0, c=c, active=None):
            return krylov.bicgstab_momentum_batched(x0, c, tol=1e-6, maxiter=20, active=active)

        def plain(x0=x0, c=c):
            return krylov.bicgstab_momentum_batched_plain(x0, c, tol=1e-6, maxiter=20)

        got, want = kernel(), plain()
        bit_equal, iters, single_ms = True, [], []
        for b in range(B):
            cb = StencilCoeffs(*(getattr(c, f)[b] for f in ("a_e", "a_w", "a_n", "a_s", "a_p",
                                                             "src")))

            def one_case(x=x0[b], cb=cb):
                return krylov.bicgstab_momentum(x, cb, tol=1e-6, maxiter=20)

            bit_equal &= torch.equal(got[b], one_case())
            single_ms.append(device_ms(one_case))
            with count_applies() as applies:
                krylov.bicgstab_momentum_plain(x0[b], cb, tol=1e-6, maxiter=20)
            iters.append((applies[0] - 1) // 2)
        frozen = kernel(active=torch.tensor([True, False, True], device=dev))
        torch_sync()
        frozen_ok = torch.equal(frozen[1], x0[1]) and torch.equal(frozen[0], got[0]) and \
            torch.equal(frozen[2], got[2])
        a, r = max_err(got, want)
        work = [sum(w) for w in zip(*(bicgstab_work(x0[0].numel(), k) for k in iters))]
        size, cl_ms = sizes["K7"]
        rows.append(case_axis_row(
            "bicgstab_momentum_batched", kernel, plain,
            dict(field=field, shape=list(x0.shape[1:]), reynolds=list(res), iterations=iters,
                 single_device_ms=single_ms,
                 ok=r < 1e-4 and bit_equal and frozen_ok, bit_equal_to_single=bit_equal,
                 frozen_case_ok=frozen_ok, max_abs_err=a, rel_err=r), B, size, cl_ms, 0,
            tuple(work), max(k7_barriers(k) for k in iters)))
    # K5: each case's hierarchy at the headline configuration
    levels, b, pres = ci["levels"], ci["b"], inp["pres"]
    meta = meta_of(levels)
    p0 = torch.zeros_like(b)

    def kernel(active=None):
        return mg.fused_mg_solve_batched(p0, b, levels, pres, active=active)

    def plain():
        return mg.fused_mg_solve_batched_plain(p0, b, levels, pres)

    got, want = kernel(), plain()
    bit_equal, single_ms = True, []
    for k, case in enumerate(ci["cases"]):
        def one_case(k=k, lv=case["levels"]):
            return mg.fused_mg_solve(p0[k], b[k], lv, pres)

        bit_equal &= all(torch.equal(g[k], o) for g, o in zip(got, one_case()))
        single_ms.append(device_ms(one_case))
    frozen = kernel(active=torch.tensor([False, True, True], device=dev))
    torch_sync()
    frozen_ok = (torch.equal(frozen[0][0], p0[0]) and not bool(frozen[1][0].any())
                 and int(frozen[2][0]) == 0 and float(frozen[3][0]) == 0.0
                 and all(torch.equal(f[k], g[k]) for f, g in zip(frozen, got) for k in (1, 2)))
    cycles = [int(x) for x in want[2]]
    a, e = max_err(got[0], want[0])
    ok = ([int(x) for x in got[2]] == cycles and e < 1e-4
          and float((got[3] - want[3]).abs().max()) < 1e-5)
    work = [sum(w) for w in zip(*(mg_solve_work(meta, pres, c) for c in cycles))]
    size, cl_ms = sizes["K5"]
    rows.append(case_axis_row(
        "fused_mg_solve_batched", kernel, plain,
        dict(hierarchy="vertex63", shape=list(b.shape[1:]), reynolds=list(res), cycles=cycles,
             single_device_ms=single_ms,
             ok=ok and bit_equal and frozen_ok, bit_equal_to_single=bit_equal,
             frozen_case_ok=frozen_ok, max_abs_err=a, rel_err=e), B, size, cl_ms, 1,
        tuple(work), max(k5_barriers(meta, pres, c) for c in cycles)))
    # K4: each case's fine stencil
    fine, shapes = levels[0][0], [lv[1] for lv in levels]
    names = ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")

    def kernel(active=None):
        return mg.galerkin_levels_batched(fine, shapes, True, active=active)

    def plain():
        return mg.galerkin_levels_batched_plain(fine, shapes, True)

    got, want = kernel(), plain()
    bit_equal, single_ms = True, []
    for k in range(B):
        def one_case(st=Stencil9(*(getattr(fine, f)[k] for f in names))):
            return mg.galerkin_levels(st, shapes, True)

        bit_equal &= all(torch.equal(getattr(g, f)[k], getattr(o, f))
                         for g, o in zip(got, one_case()) for f in names)
        single_ms.append(device_ms(one_case))
    frozen = kernel(active=torch.tensor([True, True, False], device=dev))
    torch_sync()
    frozen_ok = all(not bool(getattr(fz, f)[2].any())
                    and torch.equal(getattr(fz, f)[:2], getattr(g, f)[:2])
                    for fz, g in zip(frozen, got) for f in names)
    worst_abs = worst_rel = 0.0
    for g, w in zip(got, want):
        for f in names:
            a, r = max_err(getattr(g, f), getattr(w, f))
            worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
    size, cl_ms = sizes["K4"]
    one_work = rap_work(meta)
    rows.append(case_axis_row(
        "galerkin_levels_batched", kernel, plain,
        dict(shape=[NH, NH], levels=[shp[0] for shp in shapes], reynolds=list(res),
             single_device_ms=single_ms,
             ok=worst_rel < 1e-5 and bit_equal and frozen_ok, bit_equal_to_single=bit_equal,
             frozen_case_ok=frozen_ok, max_abs_err=worst_abs, rel_err=worst_rel),
        B, size, cl_ms, 2, (B * one_work[0], B * one_work[1]), len(shapes) - 1))
    return rows


def grid_case_inputs(n, dev, res=BATCH_RE, steps=3):
    """K7's grid-form inputs at n^2 for the cases ``res``: the lid-driven
    cavity after ``steps`` steps of the command line's default solvers at
    Re 100 from rest, and each case's relaxed u and v momentum systems at
    its own viscosity, stacked with a leading case axis."""
    import torch

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.core.bc import apply_velocity_bcs
    from naviflow_tpu_torch.ops.powerlaw import (relax_coefficients, u_momentum_coefficients,
                                                 v_momentum_coefficients)
    from naviflow_tpu_torch.ops.stencil import StencilCoeffs

    mesh, bc = nt.StructuredMesh(nx=n, ny=n), nt.lid_driven_cavity(1.0)
    st, _, _ = large_single(dev, n, 100.0, steps, configs=cli_default_configs())
    u, v = apply_velocity_bcs(st.u, st.v, bc)
    cs = {"u": [], "v": []}
    for re_ in res:
        kw = dict(dx=mesh.dx, dy=mesh.dy, rho=1.0, mu=1.0 / re_)
        cs["u"].append(relax_coefficients(u_momentum_coefficients(u, v, st.p, **kw), u, 0.7))
        cs["v"].append(relax_coefficients(v_momentum_coefficients(u, v, st.p, **kw), v, 0.7))

    def stack(key):
        return StencilCoeffs(*(torch.stack([getattr(c, f) for c in cs[key]])
                               for f in ("a_e", "a_w", "a_n", "a_s", "a_p", "src")))

    return dict(u=torch.stack([u] * len(res)), v=torch.stack([v] * len(res)),
                cu=stack("u"), cv=stack("v"))


def check_grid_case_axis(dev, sync_ms, res=BATCH_RE):
    """The batched K7 in its grid form (``nf_bicgstab_grid_batched``: one
    cooperative grid for every case) at B = 3 (Re ``res``, each case's own
    u and v systems, ``grid_case_inputs``) on the fields of
    ``GRID_CASE_GRIDS`` (tolerance 1e-6 and 60 iterations, the command
    line's default), and on the largest field the gate admits
    (``GRID_CASE_LARGEST``, the u field, 20 iterations): every case
    bit-equal to its single launch (each single launch's device ms beside
    the batched launch's), the batched plain version within 1e-4 of the
    field (K7's tolerance), a frozen case given x0 back and the other
    cases' bits kept; the plain version timed on the 256^2 fields only.
    The bound: the cases' summed work, and the slowest
    case's barriers (3 + 5 a iteration) once at one grid barrier's time at
    the single launch's blocks (``sync_ms(cells)``)."""
    import torch

    from naviflow_tpu_torch.ops import krylov
    from naviflow_tpu_torch.ops.stencil import StencilCoeffs

    rows = []
    for n in GRID_CASE_GRIDS + (GRID_CASE_LARGEST,):
        ci = grid_case_inputs(n, dev, res)
        maxiter = 20 if n == GRID_CASE_LARGEST else 60
        for field in ("u",) if n == GRID_CASE_LARGEST else ("u", "v"):
            x0, c = ci[field], ci["c" + field]
            shape = tuple(x0.shape[1:])
            assert not krylov.band_layout(shape, krylov.cluster_size(dev))[1]

            def kernel(x0=x0, c=c, active=None, maxiter=maxiter):
                return krylov.bicgstab_momentum_batched(x0, c, tol=1e-6, maxiter=maxiter,
                                                        active=active)

            def plain(x0=x0, c=c, maxiter=maxiter):
                return krylov.bicgstab_momentum_batched_plain(x0, c, tol=1e-6, maxiter=maxiter)

            before = krylov.GRID_BATCH_LAUNCHES
            got, want = kernel(), plain()
            launched = krylov.GRID_BATCH_LAUNCHES - before
            bit_equal, iters, single_ms = True, [], []
            for b in range(len(res)):
                cb = StencilCoeffs(*(getattr(c, f)[b] for f in ("a_e", "a_w", "a_n", "a_s",
                                                                 "a_p", "src")))

                def one_case(x=x0[b], cb=cb, maxiter=maxiter):
                    return krylov.bicgstab_momentum(x, cb, tol=1e-6, maxiter=maxiter)

                bit_equal &= torch.equal(got[b], one_case())
                single_ms.append(device_ms(one_case))
                with count_applies() as applies:
                    krylov.bicgstab_momentum_plain(x0[b], cb, tol=1e-6, maxiter=maxiter)
                iters.append((applies[0] - 1) // 2)
            frozen = kernel(active=torch.tensor([True, False, True], device=dev))
            torch_sync()
            frozen_ok = (torch.equal(frozen[1], x0[1]) and torch.equal(frozen[0], got[0])
                         and torch.equal(frozen[2], got[2]))
            a, r = max_err(got, want)
            main = n == GRID_CASE_GRIDS[0]
            if main:
                ms, plain_ms, dev_ms = time_pair(plain, kernel)
            else:  # the other shapes' plain version is not timed (the script's budget)
                ms, plain_ms, dev_ms = time_ms(kernel), None, device_ms(kernel)
            cells = x0[0].numel()
            bar = 3 + 5 * max(iters)  # krylov.cuh: the slowest case's, once
            work = [sum(w) for w in zip(*(bicgstab_work(cells, k) for k in iters))]
            rows.append(dict(
                name="bicgstab_momentum_grid_batched", field=field, shape=list(shape),
                reynolds=list(res), maxiter=maxiter, iterations=iters, cases=len(res),
                launched_grid_form=launched == 1, single_device_ms=single_ms,
                single_device_ms_sum=sum(single_ms),
                ok=r < 1e-4 and bit_equal and frozen_ok and launched == 1,
                bit_equal_to_single=bit_equal, frozen_case_ok=frozen_ok, max_abs_err=a,
                rel_err=r, ms=ms, plain_ms=plain_ms, device_ms=dev_ms, host_ms=host_ms(kernel),
                work=tuple(work), grid_barriers=bar,
                barrier_bound_ms=bar * sync_ms(cells), main=main))
    return rows


def large_case_inputs(dev, res=BATCH_RE):
    """The 1024^2 kernels' inputs for the cases ``res``: each case's noisy
    cavity state (``cavity_fields``, its own seed), its own viscosity and
    the bounds of its own assembly (K1's arguments), stacked with a leading
    case axis; each case's hierarchy from the d-fields of its own K1 output
    (``fine_levels``' configuration); seeded p, b and coarse corrections a
    level (K2) and a right-hand side for the 256^2 tail (K3)."""
    import numpy as np
    import torch

    from naviflow_tpu_torch.ops import asmcheby
    from naviflow_tpu_torch.ops.powerlaw import (case_conductances, relax_coefficients,
                                                 u_momentum_coefficients,
                                                 v_momentum_coefficients)
    from naviflow_tpu_torch.ops.stencil9 import Stencil9
    from naviflow_tpu_torch.solvers.momentum import _u_interior_mask, _v_interior_mask
    from naviflow_tpu_torch.solvers.multigrid import MultigridConfig, build_levels

    cfg = MultigridConfig(tolerance=0.0, max_cycles=1, pre_smoothing=1, post_smoothing=1,
                          coarsest_sweeps=32, coarse_rebuild_every=8)
    cases = []
    for k, re_ in enumerate(res):
        u, v, p, kw = cavity_fields(N, dev, seed=SEED + 10 + k)
        kw = dict(kw, mu=1.0 / re_)
        rho_u = asmcheby._masked_ratio_max(
            relax_coefficients(u_momentum_coefficients(u, v, p, **kw), u, 0.7),
            _u_interior_mask(u.shape, device=dev))
        rho_v = asmcheby._masked_ratio_max(
            relax_coefficients(v_momentum_coefficients(u, v, p, **kw), v, 0.7),
            _v_interior_mask(v.shape, device=dev))
        a = k1_args(kw, rho_u, rho_v)
        out = asmcheby.fused_asmcheby_pair(u, v, p, **a)
        levels = build_levels(out[4], out[5], cfg, dx=kw["dx"], dy=kw["dy"], rho=1.0,
                              variant="consistent")
        cases.append(dict(fields=(u, v, p), args=a, levels=levels))
    a0 = cases[0]["args"]
    k1 = dict(dx=a0["dx"], dy=a0["dy"], rho=1.0, alpha=0.7, degree=4,
              poisson_variant="consistent",
              visc=case_conductances([1.0 / re_ for re_ in res], a0["dx"], a0["dy"],
                                     torch.float32, dev),
              bounds_u=tuple(torch.stack([c["args"]["bounds_u"][i] for c in cases])
                             for i in range(3)),
              bounds_v=tuple(torch.stack([c["args"]["bounds_v"][i] for c in cases])
                             for i in range(3)))
    fields = tuple(torch.stack([c["fields"][i] for c in cases]) for i in range(3))
    names = ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")
    levels = [(Stencil9(*(torch.stack([getattr(c["levels"][lvl][0], f) for c in cases])
                          for f in names)), shp, five, lam)
              for lvl, (_, shp, five, lam) in enumerate(cases[0]["levels"])]
    rng = np.random.default_rng(SEED + 5)

    def rnd(shape):
        return torch.as_tensor(rng.normal(size=(len(res), *shape)), dtype=torch.float32,
                               device=dev)

    return dict(cases=cases, fields=fields, k1=k1, levels=levels, cfg=cfg, rnd=rnd)


def check_large_case_axis(dev, cl_ms, k3_size, res=BATCH_RE):
    """The batched K1 (1024^2, degree 4), K2a and K2b (the 1024^2 five-point
    and 512^2 nine-point levels) and K3 (the 256^2 -> 4^2 tail), each at
    B = 3 with the Re ``res`` cases of ``large_case_inputs``: every case
    bit-equal to its single launch in every output (each single launch's
    device ms beside the batched one's); the batched plain version within
    the single kernel's tolerance (K1: ``check_asmcheby``'s; K2:
    ``strip_close``; K3: 1e-5 of the output's scale); a frozen case (the
    middle one) returns its frozen outputs (K1: its u and v, zeros
    elsewhere; K2a: its p and a zero coarse residual; K2b and K3: its p)
    and leaves the other cases' bits alone.  Work: the cases' sum; K3's
    barrier bound: the slowest case's barriers times its waves."""
    import torch

    from naviflow_tpu_torch.ops import _cuda, asmcheby, mg, strip
    from naviflow_tpu_torch.ops.stencil9 import Stencil9

    ci = large_case_inputs(dev, res)
    B = len(res)
    frozen_flags = torch.tensor([k != 1 for k in range(B)], device=dev)
    rows = []

    # K1
    u, v, p = ci["fields"]

    def k1(active=None):
        return asmcheby.fused_asmcheby_pair_batched(u, v, p, active=active, **ci["k1"])

    def k1_plain():
        return asmcheby.fused_asmcheby_pair_batched_plain(u, v, p, **ci["k1"])

    got, want = asmcheby._flat(k1()), asmcheby._flat(k1_plain())
    bit_equal, single_ms = True, []
    for k, case in enumerate(ci["cases"]):
        def one_case(case=case):
            return asmcheby.fused_asmcheby_pair(*case["fields"], **case["args"])

        bit_equal &= all(torch.equal(g[k], o) for g, o in zip(got, asmcheby._flat(one_case())))
        single_ms.append(device_ms(one_case))
    fz = asmcheby._flat(k1(active=frozen_flags))
    torch_sync()
    frozen_ok = (torch.equal(fz[0][1], u[1]) and torch.equal(fz[2][1], v[1])
                 and not any(bool(fz[i][1].any()) for i in (1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12))
                 and all(torch.equal(f[k], g[k]) for f, g in zip(fz, got) for k in (0, 2)))
    tols = [2e-5, 5e-5, 2e-5, 5e-5, 2e-5, 2e-5] + [2e-5] * 5 + [1e-6, 1e-6]
    worst_abs, ok = 0.0, True
    for g, w, tol in zip(got, want, tols):
        for k in range(B):
            e_abs, e_rel = max_err(g[k], w[k])
            worst_abs = max(worst_abs, e_abs)
            ok &= e_rel < tol
    n, degree = N, 4
    faces = 2 * n * (n + 1)
    one_work = (4 * (faces + n * n + 3 * faces + 5 * n * n + 2),
                faces * (70 + degree * (APPLY5 + 8) + 10) + 10 * n * n)
    ms, plain_ms, dev_ms = time_pair(k1_plain, k1)
    rows.append(dict(name="fused_asmcheby_pair_batched", shape=[n, n], degree=degree,
                     cases=B, reynolds=list(res), ok=ok and bit_equal and frozen_ok,
                     bit_equal_to_single=bit_equal, frozen_case_ok=frozen_ok,
                     max_abs_err=worst_abs, single_device_ms=single_ms, ms=ms,
                     plain_ms=plain_ms, device_ms=dev_ms, host_ms=host_ms(k1),
                     work=(B * one_work[0], B * one_work[1])))
    # K2a, K2b on levels 0 and 1
    levels, cfg, rnd = ci["levels"], ci["cfg"], ci["rnd"]
    for lvl in (0, 1):
        st, (nl, _), five, _ = levels[lvl]
        pb, bb, ec = rnd((nl, nl)), rnd((nl, nl)), rnd((nl // 2, nl // 2))

        def down(active=None, st=st, pb=pb, bb=bb, five=five):
            return strip.strip_down_batched(pb, bb, st, cfg, five, active=active)

        def down_plain(st=st, pb=pb, bb=bb, five=five):
            return strip.strip_down_batched_plain(pb, bb, st, cfg, five)

        xd = down_plain()[0]

        def up(active=None, st=st, xd=xd, bb=bb, ec=ec, five=five):
            return strip.strip_up_batched(xd, bb, st, ec, cfg, five, active=active)

        def up_plain(st=st, xd=xd, bb=bb, ec=ec, five=five):
            return strip.strip_up_batched_plain(xd, bb, st, ec, cfg, five)

        gd, wd, gu, wu = down(), down_plain(), up(), up_plain()
        bit_d = bit_u = True
        single_d, single_u = [], []
        for k in range(B):
            stk = Stencil9(*(getattr(st, f)[k] for f in ("c", "e", "w", "n", "s", "ne", "nw",
                                                         "se", "sw")))

            def one_down(k=k, stk=stk):
                return strip.strip_down(pb[k], bb[k], stk, cfg, five)

            def one_up(k=k, stk=stk):
                return strip.strip_up(xd[k], bb[k], stk, ec[k], cfg, five)

            bit_d &= all(torch.equal(g[k], o) for g, o in zip(gd, one_down()))
            bit_u &= torch.equal(gu[k], one_up())
            single_d.append(device_ms(one_down))
            single_u.append(device_ms(one_up))
        fd, fu = down(active=frozen_flags), up(active=frozen_flags)
        torch_sync()
        frozen_d = (torch.equal(fd[0][1], pb[1]) and not bool(fd[1][1].any())
                    and all(torch.equal(f[k], g[k]) for f, g in zip(fd, gd) for k in (0, 2)))
        frozen_u = torch.equal(fu[1], xd[1]) and all(torch.equal(fu[k], gu[k]) for k in (0, 2))
        ok_d = all(strip_close(g[k], w[k]) for g, w in zip(gd, wd) for k in range(B))
        ok_u = all(strip_close(gu[k], wu[k]) for k in range(B))
        cells, a, taps = nl * nl, _apply_ops(five), (5 if five else 9)
        down_work = (4 * (cells * (2 + taps) + cells + cells // 4),
                     cells * (cfg.pre_smoothing * (a + GS_UPDATE) + a + 1) + 3 * cells)
        up_work = (4 * (cells * (2 + taps) + cells // 4 + cells),
                   cells * (4 + cfg.post_smoothing * (a + GS_UPDATE)))
        for name, fn, plain, okk, bit, frz, single, work, errs in (
                ("strip_down_batched", down, down_plain, ok_d, bit_d, frozen_d, single_d,
                 down_work, [max_err(g, w)[0] for g, w in zip(gd, wd)]),
                ("strip_up_batched", up, up_plain, ok_u, bit_u, frozen_u, single_u, up_work,
                 [max_err(gu, wu)[0]])):
            ms, plain_ms, dev_ms = time_pair(plain, fn)
            rows.append(dict(name=name, shape=[nl, nl], five_point=five, cases=B,
                             reynolds=list(res), ok=okk and bit and frz,
                             bit_equal_to_single=bit, frozen_case_ok=frz,
                             max_abs_err=max(errs), single_device_ms=single, ms=ms,
                             plain_ms=plain_ms, device_ms=dev_ms, host_ms=host_ms(fn),
                             work=(B * work[0], B * work[1])))
    # K3 on the tail
    tail = levels[2:]
    nt_ = tail[0][1][0]
    bt = rnd((nt_, nt_))
    pt = torch.zeros_like(bt)
    assert mg.supports_fused(mg._case_levels(tail, 0), cfg)

    def k3(active=None):
        return mg.fused_vcycle_batched(pt, bt, tail, cfg, active=active)

    def k3_plain():
        return mg.fused_vcycle_batched_plain(pt, bt, tail, cfg)

    got3, want3 = k3(), k3_plain()
    bit3, single3 = True, []
    for k in range(B):
        def one3(k=k):
            return mg.fused_vcycle(pt[k], bt[k], mg._case_levels(tail, k), cfg)

        bit3 &= torch.equal(got3[k], one3())
        single3.append(device_ms(one3))
    pf = rnd((nt_, nt_))
    f3 = k3(active=frozen_flags)
    f3p = mg.fused_vcycle_batched(pf, bt, tail, cfg, active=frozen_flags)
    torch_sync()
    frozen3 = (torch.equal(f3[1], pt[1]) and torch.equal(f3p[1], pf[1])
               and all(torch.equal(f3[k], got3[k]) for k in (0, 2)))
    errs3 = [max_err(got3[k], want3[k]) for k in range(B)]
    ms, plain_ms, dev_ms = time_pair(k3_plain, k3)
    meta = meta_of(tail)
    fit = _cuda.case_max_clusters(3, k3_size)
    waves = -(-B // fit)
    bar = k3_barriers(meta, cfg)
    work = vcycle_work(meta, cfg)
    rows.append(dict(name="fused_vcycle_batched", shape=[nt_, nt_],
                     levels=[m[0][0] for m in meta], cases=B, reynolds=list(res),
                     ok=max(r for _, r in errs3) < 1e-5 and bit3 and frozen3,
                     bit_equal_to_single=bit3, frozen_case_ok=frozen3,
                     max_abs_err=max(a for a, _ in errs3), rel_err=max(r for _, r in errs3),
                     single_device_ms=single3, ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                     host_ms=host_ms(k3), work=(B * work[0], B * work[1]),
                     cluster_size=k3_size, max_active_clusters=fit, waves=waves,
                     cluster_barriers=bar, barrier_bound_ms=waves * bar * cl_ms))
    return rows


def check_assembly(dev):
    """K8 at 2048^2 from a seeded cavity state: plain, with the Gershgorin
    maxima, and with each Poisson fold; coefficients at rtol/atol 1e-5,
    maxima at rtol 1e-6, d and the operator at rtol 1e-6 / atol 1e-9
    (tests/test_pallas_assembly.py's tolerances)."""
    import torch

    from naviflow_tpu_torch.ops import assembly

    u, v, p, kw = cavity_fields(NL, dev)
    alpha = 0.7
    rows = []
    for bounds, variant in ((False, None), (True, None), (False, "consistent"),
                            (False, "symmetric"), (False, "reference")):
        args = dict(alpha=alpha, with_bounds=bounds, poisson_variant=variant, **kw)
        got = assembly.fused_assembly_pair(u, v, p, **args)
        want = assembly.fused_assembly_pair_plain(u, v, p, **args)
        torch_sync()
        ok, worst_abs = True, 0.0
        pairs = [(getattr(g, f), getattr(w, f)) for g, w in zip(got[:4], want[:4])
                 for f in ("a_e", "a_w", "a_n", "a_s", "a_p", "src")]
        for g, w in pairs:
            worst_abs = max(worst_abs, max_err(g, w)[0])
            ok &= bool(torch.allclose(g, w, rtol=1e-5, atol=1e-5))
        rest_g, rest_w = got[4:], want[4:]
        if bounds:
            for g, w in zip(rest_g[:2], rest_w[:2]):
                worst_abs = max(worst_abs, max_err(g, w)[0])
                ok &= abs(float(g) - float(w)) <= 1e-6 * abs(float(w))
            rest_g, rest_w = rest_g[2:], rest_w[2:]
        if variant is not None:
            fold = [(rest_g[0], rest_w[0]), (rest_g[1], rest_w[1])] + [
                (getattr(rest_g[2], f), getattr(rest_w[2], f))
                for f in ("a_e", "a_w", "a_n", "a_s", "diag")]
            for g, w in fold:
                worst_abs = max(worst_abs, max_err(g, w)[0])
                ok &= bool(torch.allclose(g, w, rtol=1e-6, atol=1e-9))

        def kernel():
            assembly.fused_assembly_pair(u, v, p, **args)

        ms, plain_ms, dev_ms = time_pair(
            lambda: assembly.fused_assembly_pair_plain(u, v, p, **args), kernel, reps=10)
        rows.append(dict(name="fused_assembly_pair", shape=[NL, NL], with_bounds=bounds,
                         poisson_variant=variant, ok=ok, max_abs_err=worst_abs, ms=ms,
                         plain_ms=plain_ms, device_ms=dev_ms, host_ms=host_ms(kernel, 10),
                         work=assembly_work(NL, variant is not None),
                         main=bounds and variant is None))
    return rows


def check_cheby(dev):
    """K9 on the u and v systems of a 2048^2 cavity state, degree 4: x* and
    the masked residual within 2e-5 of each output's scale
    (tests/test_pallas_cheby.py's tolerance)."""
    from naviflow_tpu_torch.ops import cheby
    from naviflow_tpu_torch.ops.powerlaw import (relax_coefficients, u_momentum_coefficients,
                                                 v_momentum_coefficients)
    from naviflow_tpu_torch.solvers.momentum import _chebyshev_bounds
    from naviflow_tpu_torch.ops.stencil import interior_mask

    u, v, p, kw = cavity_fields(NL, dev)
    degree = 4
    rows = []
    for field, x0, fn in (("u", u, u_momentum_coefficients), ("v", v, v_momentum_coefficients)):
        c_un = fn(u, v, p, **kw)
        c_rel = relax_coefficients(c_un, x0, 0.7)
        bounds = _chebyshev_bounds(c_rel, interior_mask(x0.shape, 1, 1, 1, 1, device=dev))
        args = dict(theta=bounds[0], delta=bounds[1], sigma1=bounds[2], degree=degree)
        got = cheby.chebyshev_momentum_strips(x0, c_rel, c_un, **args)
        want = cheby.chebyshev_momentum_strips_plain(x0, c_rel, c_un, **args)
        torch_sync()
        errs = [max_err(g, w) for g, w in zip(got, want)]
        def kernel():
            cheby.chebyshev_momentum_strips(x0, c_rel, c_un, **args)

        ms, plain_ms, dev_ms = time_pair(
            lambda: cheby.chebyshev_momentum_strips_plain(x0, c_rel, c_un, **args), kernel,
            reps=10)
        n = x0.numel()
        rows.append(dict(name="chebyshev_momentum_strips", field=field, shape=list(x0.shape),
                         degree=degree, ok=all(r < 2e-5 for _, r in errs),
                         max_abs_err=max(a for a, _ in errs), rel_err=[r for _, r in errs],
                         ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                         host_ms=host_ms(kernel, 10), work=cheby_work(n, degree)))
    return rows


def check_step_bodies(dev, cl_ms):
    """K6's simplec, piso and simpler bodies: three chained 63^2 steps from
    rest, u, v, p within 2e-4, equal cycle counts, the scalar results within
    2e-4 (the simple body's tolerances, tests/test_pallas.py)."""
    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.ops import step

    rows = []
    mesh, _, bc = cavity_case(NH)
    _, pres = headline_configs()
    shapes = step.step_shapes(NH, NH, pres)
    meta = [(shp, lvl == 0) for lvl, shp in enumerate(shapes)]
    for algo, (cfg, kw, sc0, carry) in body_cases(dev).items():
        if algo == "simple":
            continue
        n_solves = 4 if algo == "simpler" else 2
        s = nt.initialize_state(mesh, bc, device=dev)
        u, v, p, sc = s.u, s.v, s.p, sc0
        worst_abs = worst_rel = 0.0
        ok = True
        for _ in range(3):
            got = step.fused_outer_step(algo, u, v, p, sc, **kw)
            with count_applies() as applies:
                want = step.fused_outer_step_plain(algo, u, v, p, sc, **kw)
            torch_sync()
            for g, w in zip(got[:3], want[:3]):
                a, r = max_err(g, w)
                worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
                ok &= r < 2e-4
            for g, w in zip(got[3], want[3]):
                ok &= abs(float(g) - float(w)) <= 2e-4 * abs(float(w)) + 1e-6
            ok &= int(got[4]) == int(want[4])
            ins = (u, v, p, sc)
            cycles, k_total = int(want[4]), (applies[0] - n_solves) // 2
            u, v, p, sc = want[0], want[1], want[2], carry(want[3])
        u, v, p, sc = ins

        def kernel():
            step.fused_outer_step(algo, u, v, p, sc, **kw)

        ms, plain_ms, dev_ms = time_pair(
            lambda: step.fused_outer_step_plain(algo, u, v, p, sc, **kw), kernel, reps=5)
        pairs = 2 if algo == "simpler" else 1
        jacobi_pairs = cfg.n_corrections - 1 if algo == "piso" else 0
        psolves = cfg.n_corrections if algo == "piso" else 1 + (algo == "simpler")
        bar = k6_barriers(algo, cfg, meta, pres, k_total, cycles, psolves)
        rows.append(dict(name=f"fused_outer_step[{algo}]", shape=[NH, NH], chained_steps=3,
                         cycles=cycles, krylov_iterations=k_total, ok=ok,
                         max_abs_err=worst_abs, rel_err=worst_rel, ms=ms, plain_ms=plain_ms,
                         device_ms=dev_ms, host_ms=host_ms(kernel),
                         work=step_work(NH, meta, pres, k_total, cycles,
                                        pairs + jacobi_pairs, psolves),
                         cluster_barriers=bar, barrier_bound_ms=bar * cl_ms))
    return rows


def body_cases(dev):
    """K6's four bodies at 63^2 with the headline configuration: algo ->
    (config, the kernel's keyword arguments, the scalar carries from rest,
    the carries a step's scalar results give the next step)."""
    import torch

    from naviflow_tpu_torch.algorithms import (PISOConfig, SIMPLECConfig, SIMPLEConfig,
                                               SIMPLERConfig)

    mesh, _, bc = cavity_case(NH)
    mom, pres = headline_configs()
    out = {}
    for algo, cfg in (("simple", SIMPLEConfig()), ("simplec", SIMPLECConfig()),
                      ("piso", PISOConfig()), ("simpler", SIMPLERConfig())):
        kw = dict(dx=mesh.dx, dy=mesh.dy, rho=1.0, mu=1.0 / RE, bc=bc, cfg=cfg, mom_cfg=mom,
                  pres_cfg=pres)
        if algo == "simplec":
            sc0 = (torch.full((), cfg.alpha_p, device=dev), torch.full((), math.inf, device=dev))
            carry = lambda res: tuple(res[:2])  # noqa: E731
        else:
            sc0 = (torch.zeros((), device=dev),)
            carry = lambda res: (res[0],)  # noqa: E731
        out[algo] = (cfg, kw, sc0, carry)
    return out


def k6_phases(dev, steps=20):
    """K6's phase split (``nf_fused_outer_step_phases``, phase timers read by
    thread 0 of block 0 from %globaltimer) over ``steps`` chained kernel
    steps from rest for each body at 63^2: ms per step of each phase and
    the phase count per step, the sum, and the CUDA-event time of the same
    steps through the untimed kernel (``fused_outer_step``)."""
    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.ops import step

    mesh, _, bc = cavity_case(NH)
    rows = {}
    for algo, (cfg, kw, sc0, carry) in body_cases(dev).items():
        s = nt.initialize_state(mesh, bc, device=dev)
        u, v, p, sc = s.u, s.v, s.p, sc0
        ins = []
        total = {name: [0.0, 0] for name in step.PHASE_NAMES}
        for _ in range(steps):
            ins.append((u, v, p, sc))
            out, ph = step.fused_outer_step_phases(algo, u, v, p, sc, **kw)
            for name, (ms, count) in ph.items():
                total[name][0] += ms
                total[name][1] += count
            u, v, p, sc = out[0], out[1], out[2], carry(out[3])
        box = iter(ins * 2)

        def one():
            a, b, c, d = next(box)
            step.fused_outer_step(algo, a, b, c, d, **kw)

        one()
        event = time_ms(one, reps=steps)
        split = {name: ms / steps for name, (ms, _) in total.items()}
        rows[algo] = dict(phases_ms=split,
                          phase_counts={name: c / steps for name, (_, c) in total.items()},
                          sum_ms=sum(split.values()), event_ms=event)
    return dict(phase="k6_phases", grid=NH, steps=steps, bodies=rows)


def k3_phases(cases, reps=REPS):
    """K3's phase split (``nf_fused_vcycle_phases``: %globaltimer stamps
    taken by thread 0 of the first CTA) for each ``(name, levels, cfg, b)``
    hierarchy: ms per V-cycle of the levels of more than 1,024 cells going
    down (their smoothing and restriction, the last into the first smaller
    level), the smaller levels above the coarsest (both ways), the coarsest
    sweeps, and the large levels going up (prolongation and smoothing);
    their sum; and the untimed kernel's CUDA-event and device time
    (``device_ms``) over as many calls."""
    import torch

    from naviflow_tpu_torch.ops import mg

    rows = {}
    for name, levels, cfg, b in cases:
        p = torch.zeros_like(b)
        mg.fused_vcycle_phases(p, b, levels, cfg)  # warm-up
        total = {k: [0.0, 0] for k in mg.VC_PHASE_NAMES}
        for _ in range(reps):
            _, ph = mg.fused_vcycle_phases(p, b, levels, cfg)
            for k, (ms, count) in ph.items():
                total[k][0] += ms
                total[k][1] += count
        split = {k: ms / reps for k, (ms, _) in total.items()}

        def run():
            mg.fused_vcycle(p, b, levels, cfg)

        event, dev_ms = time_ms(run, reps), device_ms(run, reps)
        parts = sum(split.values())
        rows[name] = dict(levels=[lv[1][0] for lv in levels], phases_ms=split,
                          phase_counts={k: c / reps for k, (_, c) in total.items()},
                          sum_ms=parts, event_ms=event, device_ms=dev_ms,
                          sum_over_event=parts / event, sum_over_device=parts / dev_ms)
    return dict(phase="k3_phases", reps=reps, hierarchies=rows)


def k1_phases(dev, sizes=(N, NP), reps=REPS):
    """K1's phase split (``nf_asmcheby_pair_phases``: %globaltimer stamps
    taken by thread 0 of block 0 after each phase of each of its tiles,
    behind a block barrier) at each n^2 (``asmcheby_current``, degree 4):
    block 0's ms per call in the assembly, the Chebyshev steps, the
    residual / d / writes (each summed over both fields) and the pressure
    operator, their sum, block 0's tiles per call, and the untimed kernel's
    device time (``device_ms``) over as many calls.  Block 0 walks one of
    the resident blocks' share of the tiles, so its sum approaches the
    device time where the tiles divide evenly."""
    from naviflow_tpu_torch.ops import asmcheby

    rows = {}
    for n in sizes:
        fields, a = asmcheby_current(dev, n)
        asmcheby.fused_asmcheby_pair_phases(*fields, **a)  # warm-up
        total = {k: [0.0, 0] for k in asmcheby.PHASE_NAMES}
        for _ in range(reps):
            _, ph = asmcheby.fused_asmcheby_pair_phases(*fields, **a)
            for k, (ms, count) in ph.items():
                total[k][0] += ms
                total[k][1] += count
        split = {k: ms / reps for k, (ms, _) in total.items()}
        dev_ms = device_ms(lambda: asmcheby.fused_asmcheby_pair(*fields, **a), reps)
        parts = sum(split.values())
        rows[str(n)] = dict(phases_ms=split, tiles=total["pressure"][1] / reps, sum_ms=parts,
                            device_ms=dev_ms, sum_over_device=parts / dev_ms)
        del fields, a
    return dict(phase="k1_phases", degree=4, reps=reps, grids=rows)


# ---------------------------------------------------------------------------
# the plane kernels (K10) and the whole-array Poisson kernels (K11)


def plane_inputs(n, dev, seed):
    """A consistent-variant n^2 fine stencil from seeded d-fields, split into
    planes with a seeded b (``PlaneStencil5``); seeded R, B planes and a
    coarse correction."""
    import numpy as np
    import torch

    from naviflow_tpu_torch.ops.plane import PlaneStencil5, split_planes
    from naviflow_tpu_torch.ops.poisson import poisson_coefficients
    from naviflow_tpu_torch.ops.stencil9 import from_poisson

    rng = np.random.default_rng(seed)

    def rnd(shape, uniform=False):
        a = rng.uniform(0.5, 1.5, shape) if uniform else rng.normal(size=shape)
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    pc = poisson_coefficients(rnd((n + 1, n), True), rnd((n, n + 1), True), dx=1.0 / n,
                              dy=1.0 / n, rho=1.0, variant="consistent")
    ps = PlaneStencil5(from_poisson(pc), rnd((n, n)))
    R, B = split_planes(rnd((n, n)))
    return ps, R, B, rnd((n // 2, n // 2))


def check_plane(dev):
    """K10 at the 4096^2 plane shapes (planes 4096 x 2048) with the bench's
    1/1 smoothing, and at 1024^2 with 2/2 (the gate's maximum, the JAX
    tests' configuration): ``strip_close`` on every output."""
    import dataclasses

    import torch

    from naviflow_tpu_torch.ops import plane_strip

    _, pres = large_grid_configs()
    rows = []
    for n, sweeps in ((NP, 1), (1024, 2)):
        cfg = dataclasses.replace(pres, pre_smoothing=sweeps, post_smoothing=sweeps)
        ps, R, B, ec = plane_inputs(n, dev, SEED + 2)
        m, nc = R.shape
        assert plane_strip.supports_plane_strip(m, nc, cfg, torch.float32)
        got_d = plane_strip.plane_strip_down(R, B, ps, cfg)
        want_d = plane_strip.plane_strip_down_plain(R, B, ps, cfg)
        Rs, Bs = want_d[:2]
        got_u = plane_strip.plane_strip_up(Rs, Bs, ps, ec, cfg)
        want_u = plane_strip.plane_strip_up_plain(Rs, Bs, ps, ec, cfg)
        torch_sync()
        def down():
            plane_strip.plane_strip_down(R, B, ps, cfg)

        def up():
            plane_strip.plane_strip_up(Rs, Bs, ps, ec, cfg)

        ms_d, plain_d, dev_d = time_pair(
            lambda: plane_strip.plane_strip_down_plain(R, B, ps, cfg), down, reps=10)
        ms_u, plain_u, dev_u = time_pair(
            lambda: plane_strip.plane_strip_up_plain(Rs, Bs, ps, ec, cfg), up, reps=10)
        cells = m * nc
        works = {"down": plane_work(cells, sweeps, True), "up": plane_work(cells, sweeps, False)}
        for name, got, want, ms, plain_ms, dev_ms, fn in (
                ("down", got_d, want_d, ms_d, plain_d, dev_d, down),
                ("up", got_u, want_u, ms_u, plain_u, dev_u, up)):
            errs = [max_err(g, w) for g, w in zip(got, want)]
            rows.append(dict(name=f"plane_strip_{name}", shape=[m, nc], sweeps=sweeps,
                             ok=all(strip_close(g, w) for g, w in zip(got, want)),
                             max_abs_err=max(a for a, _ in errs),
                             rel_err=max(r for _, r in errs),
                             scale=max(float(w.abs().max()) for w in want), ms=ms,
                             plain_ms=plain_ms, device_ms=dev_ms, host_ms=host_ms(fn, 10),
                             work=works[name], main=n == NP))
        del ps, R, B, ec, got_d, want_d, got_u, want_u
    return rows



# ---------------------------------------------------------------------------
# the case axis of K8, K9, K10a and K10b (the batch phase's batch_assembly)


def assembly_work(n, fold):
    """K8's bytes and operations at n^2: u, v, p in, 16 coefficient arrays
    out (+ d_u, d_v and the operator's five)."""
    faces, cells = 2 * n * (n + 1), n * n
    nbytes, flops = 4 * (faces + cells + 8 * faces), faces * 80
    if fold:
        nbytes += 4 * (faces + 5 * cells)
        flops += cells * (4 * 80 + 20)
    return nbytes, flops


def cheby_work(cells, degree):
    """K9's bytes and operations on a field of ``cells`` faces: 9 arrays
    in, 2 out."""
    return 4 * 11 * cells, cells * (degree * (APPLY5 + 8) + APPLY5 + 1)


def plane_work(cells, sweeps, down):
    """K10's bytes and operations on planes of ``cells`` cells each: per
    plane cell a half-sweep update 8 operations, the normalised residual
    10, the coarse row 3 per coarse cell, the prolongation and add 10;
    bytes: 14 planes + rc_zdiag in, 2 planes + rc out (down), 12 planes +
    ec in, 2 planes out (up)."""
    if down:
        return 4 * 17 * cells, cells * (16 * sweeps + 21) + 3 * (cells // 2)
    return 4 * (14 * cells + cells // 2), cells * (20 + 16 * sweeps)


def batched_row(name, fn, plain, got, singles, frozen_ok, ok_plain, errs, work, cases, **extra):
    """One batched kernel row at B = ``cases``: every case bit-equal to its
    single launch (``singles``: per case, its single call; ``got``: the
    batched outputs, a flat tuple with the case axis first), the frozen
    case as specified, the plain version within the single kernel's
    tolerance; event, device and host ms beside each single launch's device
    ms; the work summed over the cases."""
    import torch

    bit, single_ms = True, []
    for k, one in enumerate(singles):
        outs = one()
        bit &= all(torch.equal(g[k], o) for g, o in zip(got, outs))
        single_ms.append(device_ms(one))
    ms, plain_ms, dev_ms = time_pair(plain, fn)
    return dict(name=name, cases=cases, ok=bool(bit and frozen_ok and ok_plain),
                bit_equal_to_single=bool(bit), frozen_case_ok=bool(frozen_ok),
                plain_within_tolerance=bool(ok_plain), max_abs_err=max(a for a, _ in errs),
                rel_err=max(r for _, r in errs), single_device_ms=single_ms, ms=ms,
                plain_ms=plain_ms, device_ms=dev_ms, host_ms=host_ms(fn),
                work=(cases * work[0], cases * work[1]), **extra)


def check_assembly_case_axis(dev, res=BATCH_RE):
    """The batched K8 at 2048^2 (with the Gershgorin maxima, as SIMPLEC,
    PISO and SIMPLER call it; and with the consistent fold, as SIMPLE
    does), the batched K9 on the u and v systems of a 2048^2 state (degree
    4, each case's own interval scalars) and the batched K10a / K10b on
    planes 4096 x 2048 (1 / 1 sweeps), each at B = 3 with the Re ``res``
    cases (each its own seeded state and viscosity): every case bit-equal
    to its single launch in every output; the batched plain version within
    the single kernel's tolerance (K8: ``check_assembly``'s; K9: 2e-5 of
    each output's scale; K10: ``strip_close``); a frozen case (the middle
    one) gets its frozen outputs (K8: zeros in every output; K9: x0 and a
    zero residual; K10a: R, B and a zero coarse residual; K10b: R and B)
    and leaves the other cases' bits alone."""
    import dataclasses

    import torch

    from naviflow_tpu_torch.ops import assembly, cheby, plane_strip
    from naviflow_tpu_torch.ops.plane import PlaneStencil5
    from naviflow_tpu_torch.ops.powerlaw import (case_conductances, relax_coefficients,
                                                 u_momentum_coefficients,
                                                 v_momentum_coefficients)
    from naviflow_tpu_torch.ops.stencil import StencilCoeffs, interior_mask
    from naviflow_tpu_torch.solvers.momentum import _chebyshev_bounds

    B = len(res)
    frozen_flags = torch.tensor([k != 1 for k in range(B)], device=dev)
    states = [cavity_fields(NL, dev, seed=SEED + 20 + k) for k in range(B)]
    kw = dict(states[0][3])
    del kw["mu"]
    u, v, p = (torch.stack([s[i] for s in states]) for i in range(3))
    visc = case_conductances([1.0 / re_ for re_ in res], kw["dx"], kw["dy"], torch.float32, dev)
    rows = []

    def untouched(fz, got):
        return all(torch.equal(f[k], g[k]) for f, g in zip(fz, got) for k in range(B) if k != 1)

    # K8: the main path's call (with the maxima), then SIMPLE's (the fold)
    for bounds, variant in ((True, None), (False, "consistent")):
        args = dict(alpha=0.7, with_bounds=bounds, poisson_variant=variant, **kw)

        def k8(active=None, args=args):
            return assembly.fused_assembly_pair_batched(u, v, p, visc=visc, active=active,
                                                        **args)

        def k8_plain(args=args):
            return assembly.fused_assembly_pair_batched_plain(u, v, p, visc=visc, **args)

        got, want, fz = k8_flat(k8()), k8_flat(k8_plain()), k8_flat(k8(frozen_flags))
        torch_sync()
        frozen_ok = not any(bool(f[1].any()) for f in fz) and untouched(fz, got)
        n_coef = 16
        ok_plain = all(bool(torch.allclose(g, w, rtol=1e-5, atol=1e-5))
                       for g, w in zip(got[:n_coef], want[:n_coef]))
        rest = list(zip(got[n_coef:], want[n_coef:]))
        if bounds:
            ok_plain &= all(bool(((g - w).abs() <= 1e-6 * w.abs()).all()) for g, w in rest[:2])
            rest = rest[2:]
        ok_plain &= all(bool(torch.allclose(g, w, rtol=1e-6, atol=1e-9)) for g, w in rest)
        errs = [max_err(g, w) for g, w in zip(got, want)]
        singles = [lambda k=k, args=args: k8_flat(assembly.fused_assembly_pair(
            u[k], v[k], p[k], mu=1.0 / res[k], **args)) for k in range(B)]
        rows.append(batched_row("fused_assembly_pair_batched", k8, k8_plain, got, singles,
                                frozen_ok, ok_plain, errs,
                                assembly_work(NL, variant is not None), B, shape=[NL, NL],
                                with_bounds=bounds, poisson_variant=variant,
                                reynolds=list(res), main=bounds))
        del got, want, fz
    # K9 on the u and v systems, each case its own coefficients and bounds
    degree = 4
    for field, fn in (("u", u_momentum_coefficients), ("v", v_momentum_coefficients)):
        x0s, c_uns, c_rels, bnds = [], [], [], []
        for k, (uk, vk, pk, _) in enumerate(states):
            x0 = uk if field == "u" else vk
            c_un = fn(uk, vk, pk, mu=1.0 / res[k], **kw)
            c_rel = relax_coefficients(c_un, x0, 0.7)
            bnds.append(_chebyshev_bounds(c_rel, interior_mask(x0.shape, 1, 1, 1, 1,
                                                               device=dev)))
            x0s.append(x0)
            c_uns.append(c_un)
            c_rels.append(c_rel)

        def stack_c(cs):
            return StencilCoeffs(*(torch.stack([getattr(c, f) for c in cs])
                                   for f in ("a_e", "a_w", "a_n", "a_s", "a_p", "src")))

        xb, cu_b, cr_b = torch.stack(x0s), stack_c(c_uns), stack_c(c_rels)
        theta, delta, sigma1 = (torch.stack([b[i] for b in bnds]) for i in range(3))
        sc = dict(theta=theta, delta=delta, sigma1=sigma1, degree=degree)

        def k9(active=None, xb=xb, cr_b=cr_b, cu_b=cu_b, sc=sc):
            return cheby.chebyshev_momentum_strips_batched(xb, cr_b, cu_b, active=active, **sc)

        def k9_plain(xb=xb, cr_b=cr_b, cu_b=cu_b, sc=sc):
            return cheby.chebyshev_momentum_strips_batched_plain(xb, cr_b, cu_b, **sc)

        got, want, fz = k9(), k9_plain(), k9(frozen_flags)
        torch_sync()
        frozen_ok = (torch.equal(fz[0][1], xb[1]) and not bool(fz[1][1].any())
                     and untouched(fz, got))
        errs = [max_err(g[k], w[k]) for g, w in zip(got, want) for k in range(B)]
        singles = [lambda k=k, c_rel=c_rels, c_un=c_uns, b=bnds, x=x0s:
                   cheby.chebyshev_momentum_strips(x[k], c_rel[k], c_un[k], theta=b[k][0],
                                                   delta=b[k][1], sigma1=b[k][2],
                                                   degree=degree) for k in range(B)]
        rows.append(batched_row("chebyshev_momentum_strips_batched", k9, k9_plain, got,
                                singles, frozen_ok,
                                all(r < 2e-5 for _, r in errs), errs,
                                cheby_work(xb[0].numel(), degree), B, field=field,
                                shape=list(xb.shape[1:]), degree=degree, reynolds=list(res)))
        del x0s, c_uns, c_rels, xb, cu_b, cr_b, got, want, fz
    del states, u, v, p
    # K10a / K10b on planes 4096 x 2048, each case its own stencil, b and planes
    _, pres = large_grid_configs()
    cfg = dataclasses.replace(pres, pre_smoothing=1, post_smoothing=1)
    inputs = [plane_inputs(NP, dev, SEED + 30 + k) for k in range(B)]
    pss = [x[0] for x in inputs]
    ps_b = plane_strip.PlaneArrays(
        [torch.stack([a[i] for a in map(plane_strip._norm_arrays, pss)]) for i in range(10)],
        [torch.stack([q.c[i] for q in pss]) for i in range(2)],
        torch.stack([q.rc_zdiag for q in pss]))
    R, Bp, ec = (torch.stack([x[i] for x in inputs]) for i in (1, 2, 3))
    del inputs
    m, nc = R.shape[1:]
    Rs, Bs, _ = plane_strip.plane_strip_down_batched_plain(R, Bp, ps_b, cfg)

    def down(active=None):
        return plane_strip.plane_strip_down_batched(R, Bp, ps_b, cfg, active=active)

    def down_plain():
        return plane_strip.plane_strip_down_batched_plain(R, Bp, ps_b, cfg)

    def up(active=None):
        return plane_strip.plane_strip_up_batched(Rs, Bs, ps_b, ec, cfg, active=active)

    def up_plain():
        return plane_strip.plane_strip_up_batched_plain(Rs, Bs, ps_b, ec, cfg)

    for name, fn, plain, frozen_want, singles, work in (
            ("plane_strip_down_batched", down, down_plain, (R, Bp),
             [lambda k=k: plane_strip.plane_strip_down(R[k], Bp[k], pss[k], cfg)
              for k in range(B)], plane_work(m * nc, 1, True)),
            ("plane_strip_up_batched", up, up_plain, (Rs, Bs),
             [lambda k=k: plane_strip.plane_strip_up(Rs[k], Bs[k], pss[k], ec[k], cfg)
              for k in range(B)], plane_work(m * nc, 1, False))):
        got, want, fz = fn(), plain(), fn(frozen_flags)
        torch_sync()
        frozen_ok = (all(torch.equal(f[1], w[1]) for f, w in zip(fz, frozen_want))
                     and (len(fz) == 2 or not bool(fz[2][1].any())) and untouched(fz, got))
        errs = [max_err(g[k], w[k]) for g, w in zip(got, want) for k in range(B)]
        ok_plain = all(strip_close(g[k], w[k]) for g, w in zip(got, want) for k in range(B))
        rows.append(batched_row(name, fn, plain, got, singles, frozen_ok,
                                ok_plain, errs, work, B, shape=[m, nc], sweeps=1,
                                reynolds=list(res)))
        del got, want, fz
    del pss, ps_b, R, Bp, ec, Rs, Bs
    return rows

def poisson_system(nx, ny, dev, seed):
    """tests/test_pallas.py's system: consistent-variant coefficients from
    seeded d-fields, random p and b."""
    import numpy as np
    import torch

    from naviflow_tpu_torch.ops.poisson import poisson_coefficients

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    c = poisson_coefficients(t(rng.random((nx + 1, ny)) + 0.2), t(rng.random((nx, ny + 1)) + 0.2),
                             dx=0.05, dy=0.05, rho=1.0, variant="consistent")
    return t(rng.normal(size=(nx, ny))), t(rng.normal(size=(nx, ny))), c


def poisson_csr(c):
    """The unpinned operator ``diag p - sum(a_nb p_nb)`` as a CSR matrix:
    the library yardstick of K11b (cuSPARSE SpMV), built once, not timed."""
    import torch

    nx, ny = c.diag.shape
    idx = torch.arange(nx * ny, device=c.diag.device).view(nx, ny)
    rows, cols, vals = [idx.flatten()], [idx.flatten()], [c.diag.flatten()]
    for a, di, dj in ((c.a_e, 1, 0), (c.a_w, -1, 0), (c.a_n, 0, 1), (c.a_s, 0, -1)):
        i0, i1, j0, j1 = max(0, -di), nx - max(0, di), max(0, -dj), ny - max(0, dj)
        rows.append(idx[i0:i1, j0:j1].flatten())
        cols.append(idx[i0 + di:i1 + di, j0 + dj:j1 + dj].flatten())
        vals.append(-a[i0:i1, j0:j1].flatten())
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                  torch.cat(vals), (nx * ny, nx * ny))
    return coo.coalesce().to_sparse_csr()


# K11a's cases (shape, sweeps) and K11b's shapes; K11a's 256^2 at RB_S_MAX + 2
# sweeps runs two launches
K11A_CASES = (((63, 63), 1), ((63, 63), 3), ((256, 256), 1), ((256, 256), 3),
              ((256, 256), 6), ((48, 96), 3), ((255, 257), 3), ((1024, 64), 3),
              ((64, 1024), 3))
K11B_SHAPES = ((63, 63), (256, 256), (48, 96), (255, 257))


def launch_floor_ms(dev, blocks, threads):
    """Device ms of one launch of an empty kernel of ``blocks`` x
    ``threads`` (``nf_launch_floor_probe``, timed by ``device_ms``): the
    floor under a small kernel's device time."""
    import torch

    from naviflow_tpu_torch.ops import _cuda

    lib, stream = _cuda.library(), _cuda.stream_of(torch.empty(0, device=dev))

    def probe():
        _cuda.check(lib.nf_launch_floor_probe(blocks, threads, stream), "launch_floor_probe")

    return device_ms(probe)


def check_poisson_kernels(dev):
    """K11a at ``K11A_CASES`` (omega 1.5), rtol 5e-4 / atol 2e-5; K11b at
    ``K11B_SHAPES``, rtol / atol 1e-6 (tests/test_pallas.py's tolerances),
    with a cuSPARSE SpMV of the same operator beside K11b.  Beside the
    CUDA-event times of back-to-back calls, which at these sizes hold the
    host's launch time, each kernel's device time (``device_ms``; the
    SpMV's too), its host time per call (``host_ms``) and, beside K11b, the
    device time of an empty launch of its 256^2 grid (``launch_floor_ms``).
    No path of the JAX package calls K11: its launches are counted over
    this phase's checking calls (returned) and must be
    ceil(sweeps / RBGS_S_MAX) a K11a call and one a K11b call."""
    import torch

    from naviflow_tpu_torch.ops import kernels

    reset_counts()
    checks = []
    for (nx, ny), sweeps in K11A_CASES:
        p, b, c = poisson_system(nx, ny, dev, SEED + 3)
        checks.append(("rbgs_sweeps", (nx, ny), sweeps, p, b, c,
                       kernels.rbgs_sweeps(p, b, c, n_sweeps=sweeps, omega=1.5),
                       kernels.rbgs_sweeps_plain(p, b, c, sweeps, 1.5)))
    for nx, ny in K11B_SHAPES:
        p, b, c = poisson_system(nx, ny, dev, SEED + 4)
        checks.append(("apply_poisson", (nx, ny), None, p, b, c,
                       kernels.apply_poisson_kernel(p, c), kernels.apply_poisson_plain(p, c)))
    torch_sync()
    launches = counts()
    want = only(rbgs_sweeps=sum(-(-s // kernels.RBGS_S_MAX) for _, s in K11A_CASES),
                apply_poisson=len(K11B_SHAPES))
    floor = {"256x256": launch_floor_ms(dev, 256, 256), "1x32": launch_floor_ms(dev, 1, 32)}
    emit(dict(phase="launch_floor", ms=floor, launches=launches, launches_expected=want))
    rows = []
    for name, (nx, ny), sweeps, p, b, c, got, want_out in checks:
        a, r = max_err(got, want_out)
        cells = nx * ny
        if name == "rbgs_sweeps":
            ok = bool(torch.allclose(got, want_out, rtol=5e-4, atol=2e-5))
            kernel = lambda: kernels.rbgs_sweeps(p, b, c, n_sweeps=sweeps, omega=1.5)  # noqa: E731
            ms, plain_ms, dev_ms = time_pair(
                lambda: kernels.rbgs_sweeps_plain(p, b, c, sweeps, 1.5), kernel)
            # p, b, 4 links, diag in; p out.  Per cell and sweep: the
            # neighbour sum 7, (b + sum) * invd 2, the relaxation 3; per
            # cell invd's guard and division 2
            row = dict(sweeps=sweeps, launches=-(-sweeps // kernels.RBGS_S_MAX),
                       work=(4 * 8 * cells, (12 * sweeps + 2) * cells),
                       main=(nx, ny) == (256, 256) and sweeps == 3)
        else:
            ok = bool(torch.allclose(got, want_out, rtol=1e-6, atol=1e-6))
            kernel = lambda: kernels.apply_poisson_kernel(p, c)  # noqa: E731
            ms, plain_ms, dev_ms = time_pair(lambda: kernels.apply_poisson_plain(p, c), kernel)
            A, x = poisson_csr(c), p.flatten()
            spmv = A @ x
            torch_sync()
            spmv_ok = bool(torch.allclose(spmv.view(nx, ny), want_out, rtol=1e-5, atol=1e-5))
            row = dict(library_ms=time_ms(lambda: A @ x), library_ok=spmv_ok,
                       library_device_ms=device_ms(lambda: A @ x),
                       launch_floor_ms=floor["256x256"],
                       work=(4 * 7 * cells, 9 * cells), main=(nx, ny) == (256, 256))
            ok &= spmv_ok
        rows.append(dict(name=name, shape=[nx, ny], ok=ok and launches == want,
                         max_abs_err=a, rel_err=r, ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                         host_ms=host_ms(kernel), **row))
    return rows, launches


# ---------------------------------------------------------------------------
# main paths


def counts():
    from naviflow_tpu_torch.ops import (asmcheby, assembly, cheby, kernels, krylov, mg,
                                        plane_strip, step, strip)

    return {"fused_asmcheby_pair": asmcheby.LAUNCHES,
            "strip_down": strip.STRIP_DOWN_LAUNCHES,
            "strip_up": strip.STRIP_UP_LAUNCHES,
            "fused_vcycle": mg.LAUNCHES,
            "galerkin_levels": mg.RAP_LAUNCHES,
            "fused_mg_solve": mg.SOLVE_LAUNCHES,
            "bicgstab_momentum": krylov.LAUNCHES,
            "bicgstab_momentum_grid": krylov.GRID_LAUNCHES,
            "bicgstab_momentum_batched": krylov.BATCH_LAUNCHES,
            "bicgstab_momentum_grid_batched": krylov.GRID_BATCH_LAUNCHES,
            "galerkin_levels_batched": mg.RAP_BATCH_LAUNCHES,
            "fused_mg_solve_batched": mg.SOLVE_BATCH_LAUNCHES,
            "fused_outer_step": step.LAUNCHES,
            "fused_outer_step_batched": step.BATCH_LAUNCHES,
            "fused_asmcheby_pair_batched": asmcheby.BATCH_LAUNCHES,
            "strip_down_batched": strip.STRIP_DOWN_BATCH_LAUNCHES,
            "strip_up_batched": strip.STRIP_UP_BATCH_LAUNCHES,
            "fused_vcycle_batched": mg.VC_BATCH_LAUNCHES,
            "fused_assembly_pair": assembly.LAUNCHES,
            "chebyshev_momentum_strips": cheby.LAUNCHES,
            "plane_strip_down": plane_strip.DOWN_LAUNCHES,
            "plane_strip_up": plane_strip.UP_LAUNCHES,
            "fused_assembly_pair_batched": assembly.BATCH_LAUNCHES,
            "chebyshev_momentum_strips_batched": cheby.BATCH_LAUNCHES,
            "plane_strip_down_batched": plane_strip.DOWN_BATCH_LAUNCHES,
            "plane_strip_up_batched": plane_strip.UP_BATCH_LAUNCHES,
            "rbgs_sweeps": kernels.RBGS_LAUNCHES,
            "apply_poisson": kernels.MATVEC_LAUNCHES}


def reset_counts():
    from naviflow_tpu_torch.ops import (asmcheby, assembly, cheby, kernels, krylov, mg,
                                        plane_strip, step, strip)

    asmcheby.LAUNCHES = asmcheby.BATCH_LAUNCHES = 0
    strip.STRIP_DOWN_LAUNCHES = strip.STRIP_DOWN_BATCH_LAUNCHES = 0
    strip.STRIP_UP_LAUNCHES = strip.STRIP_UP_BATCH_LAUNCHES = 0
    mg.LAUNCHES = mg.RAP_LAUNCHES = mg.SOLVE_LAUNCHES = 0
    mg.RAP_BATCH_LAUNCHES = mg.SOLVE_BATCH_LAUNCHES = mg.VC_BATCH_LAUNCHES = 0
    krylov.LAUNCHES = krylov.BATCH_LAUNCHES = 0
    krylov.GRID_LAUNCHES = krylov.GRID_BATCH_LAUNCHES = 0
    step.LAUNCHES = step.BATCH_LAUNCHES = 0
    assembly.LAUNCHES = assembly.BATCH_LAUNCHES = 0
    cheby.LAUNCHES = cheby.BATCH_LAUNCHES = 0
    plane_strip.DOWN_LAUNCHES = plane_strip.UP_LAUNCHES = 0
    plane_strip.DOWN_BATCH_LAUNCHES = plane_strip.UP_BATCH_LAUNCHES = 0
    kernels.RBGS_LAUNCHES = kernels.MATVEC_LAUNCHES = 0


def only(**nonzero):
    """The expected launch counts: the given ones, every other kernel 0."""
    return {k: nonzero.get(k, 0) for k in counts()}


def large_slice_configs(backend="auto"):
    """``bench.py``'s large-grid momentum and pressure configurations
    (Chebyshev of degree 4; one fixed V-cycle, 1/1 smoothing, 32 coarsest
    sweeps, coarse rebuild every 8 steps)."""
    from naviflow_tpu_torch.solvers import ChebyshevMomentumConfig, MultigridConfig

    return (ChebyshevMomentumConfig(degree=4, backend=backend),
            MultigridConfig(tolerance=0.0, max_cycles=1, cycle_type="v", pre_smoothing=1,
                            post_smoothing=1, coarsest_sweeps=32, coarse_rebuild_every=8,
                            backend=backend))


def solve(dev, backend):
    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import SIMPLEConfig, simple_solve

    mesh = nt.StructuredMesh(nx=N, ny=N)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=RE)
    bc = nt.lid_driven_cavity(1.0)
    mom, pres = large_slice_configs(backend)
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
    hist_c = diag_c1.total_res_history.double()
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
               history_gap=((hist - hist_c).abs() / hist_c.abs()).tolist(),
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


def device_kernels(prof):
    """{kernel name: (device ms, launches)} of a torch.profiler run: the
    device-side events only (a CPU op's self device time is the time of the
    kernels it launched, which appear again under their own names)."""
    from torch.autograd import DeviceType

    return {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


# aten operators that make the host wait for the device (a read of a value,
# or an output whose size depends on the data)
_HOST_WAITS = {"_local_scalar_dense", "nonzero", "masked_select", "_unique2", "unique_dim",
               "unique_consecutive", "equal"}


def _host_waits(func, args, kwargs):
    """True for an operator that makes the host wait for the device: the
    ones above and copies between the host and the device (a copy from
    pageable host memory waits for the stream too)."""
    import torch

    name = func.__name__.split(".")[0]
    if name in _HOST_WAITS:
        return True
    if name == "_to_copy":
        dev = kwargs.get("device")
        return dev is not None and torch.device(dev).type != args[0].device.type
    if name == "copy_":
        return args[0].device.type != args[1].device.type
    return False


def op_counter():
    """A ``TorchDispatchMode`` that counts the aten operators a run
    dispatches (``.ops``) and those among them that make the host wait for
    the device (``.waits``, ``_host_waits``); the kernel wrappers' launches
    are not operators."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = self.waits = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            self.ops += 1
            self.waits += _host_waits(func, args, kwargs)
            return func(*args, **kwargs)

    return Ops()


def queued_segments(sleeps=None, ops=128):
    """A ``TorchDispatchMode`` that splits the work a run enqueues into
    segments, each queued behind a device-side sleep (``torch.cuda._sleep``)
    and spanned by CUDA events: a segment ends before an operator that makes
    the host wait for the device (and at ``torch.cuda.synchronize``), or
    before the operator after ``ops`` of them, so the host enqueues a whole
    segment (the kernel wrappers' launches between operators included)
    while the device sleeps, and the span is the segment's device time
    without the gaps in which the device waited for the host; the host waits
    for each segment before the next.  Segment k
    sleeps ``sleeps[k]`` ms (1 ms without ``sleeps``, 50 beyond it).
    ``.spans`` holds ``(start, end, host enqueue ms, sleep ms)`` per segment
    (read after a synchronise); a segment whose enqueue outlasted its sleep
    spans an upper bound."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    real_sync = torch.cuda.synchronize

    class Segments(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.spans, self.count, self.open = [], 0, None

        def begin(self):
            k = len(self.spans)
            sleep_ms = 1.0 if sleeps is None else (sleeps[k] if k < len(sleeps) else 50.0)
            torch.cuda._sleep(int(sleep_ms * 2e6))  # ~2 GHz SM clock; slower sleeps longer
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.open, self.count = (start, time.perf_counter(), sleep_ms), 0

        def end(self):
            start, t0, sleep_ms = self.open
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.spans.append((start, end, (time.perf_counter() - t0) * 1e3, sleep_ms))
            self.open = None
            # the host waits for each segment, so it never runs ahead into
            # the launch queue's limit and its enqueueing of the next segment
            # starts with that segment's sleep
            real_sync()

        def synchronize(self, *a, **k):
            self.end()
            real_sync(*a, **k)
            self.begin()

        def __enter__(self):
            out = super().__enter__()
            torch.cuda.synchronize = self.synchronize
            self.begin()
            return out

        def __exit__(self, *exc):
            self.end()
            torch.cuda.synchronize = real_sync
            return super().__exit__(*exc)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if _host_waits(func, args, kwargs):
                self.end()
                out = func(*args, **kwargs)
                self.begin()
                return out
            if self.count >= ops:
                self.end()
                self.begin()
            self.count += 1
            return func(*args, **kwargs)

    return Segments()


def device_busy(run):
    """The device time of ``run()``, replayed in segments behind device-side
    sleeps (``queued_segments``): a first replay times the host's enqueueing
    of each segment, a second sleeps three times that plus 2 ms before each
    and sums the segments' spans.  Returns ``(busy_ms, spans)``, the spans as
    ``(device ms, host enqueue ms, sleep ms)``."""
    first = queued_segments()
    with first:
        run()
    torch_sync()
    seg = queued_segments(sleeps=[3.0 * host + 2.0 for _, _, host, _ in first.spans])
    with seg:
        run()
    torch_sync()
    spans = [(start.elapsed_time(end), host, sleep) for start, end, host, sleep in seg.spans]
    return sum(span for span, _, _ in spans), spans


_SEGMENTS_WARM = False  # profile_window: a queued_segments replay has run


def profile_window(run, steps, profiler=True):
    """The device's idle share over ``run()`` (``steps`` outer steps, warmed
    up by one call before): the window is the host clock over one run; the
    busy time is the same run's device time (``device_busy``);
    ``idle_share`` = 1 - busy / window.  Where a segment's enqueue
    outlasted its sleep all the same, its span holds at most that overrun of
    waiting (``overrun_ms``, the sum): the busy time lies between
    ``device_busy_ms - overrun_ms`` and ``device_busy_ms``.  Beside it, from
    a further run under ``torch.profiler`` (device activity alone: the host's
    operators are not traced), the profiler's sum of device-side kernel
    time (``profiler_busy_ms``, which missed launches on the H100) and its
    idle share over its own window (the profiler's overhead lengthens it),
    and the kernels by that time.  ``profiler=False`` skips that run, as the
    QUICK, distributed, large-grid batch and batch_loops profiles do:
    summing its trace of the distributed phase's 1024^2 step (some 10^5
    operators) took minutes, and the large batches' runs and traces cost
    seconds the script's budget does not have."""
    from torch.profiler import ProfilerActivity, profile

    global _SEGMENTS_WARM
    run()  # warm-up
    if not _SEGMENTS_WARM:  # the first use of a dispatch mode also loads modules
        with queued_segments():
            run()
        _SEGMENTS_WARM = True
    torch_sync()
    t0 = time.perf_counter()
    run()
    window_ms = (time.perf_counter() - t0) * 1e3
    busy, spans = device_busy(run)
    out = dict(steps=steps, window_ms=window_ms, device_busy_ms=busy,
               idle_share=1.0 - busy / window_ms, segments=len(spans),
               segments_over_sleep=sum(host >= sleep for _, host, sleep in spans),
               overrun_ms=sum(max(host - sleep, 0.0) for _, host, sleep in spans),
               max_segment_ms=max(span for span, _, _ in spans),
               sleep_ms=sum(sleep for _, _, sleep in spans))
    if not profiler:
        return out
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_window_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_kernels(prof)
    prof_busy = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(out, profiler_window_ms=prof_window_ms, profiler_busy_ms=prof_busy,
                profiler_idle_share=1.0 - prof_busy / prof_window_ms,
                top=[dict(name=k[:80], ms=t, calls=c) for k, (t, c) in top])


def device_ms(fn, reps=REPS):
    """Device time per call of ``fn``: CUDA events around ``reps`` calls
    queued behind a device-side sleep, so that the device runs them back to
    back and the host's launch time, which the event times of back-to-back
    calls include, is hidden (the sleep outlasts the host's enqueueing;
    no kernel wrapper synchronises).  The profiler's per-kernel sums are
    not used here: on the H100 they missed launches (sums below a kernel's
    byte bound, 0 for some K6 bodies)."""
    import torch

    fn()
    torch_sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch_sync()
    return start.elapsed_time(end) / reps


def run_headline(dev):
    from naviflow_tpu_torch.postprocessing.validation import infinity_norm_error

    mesh, _, _ = cavity_case(NH)
    solve_headline(dev, "auto", 1e-3, max_iterations=4)  # warm-up
    runs, ok = {}, True
    for tol in (1e-3, 1e-5):
        for backend in ("auto", "composed") if tol == 1e-3 else ("auto",):
            reset_counts()
            state, diag, wall = solve_headline(dev, backend, tol)
            launches = counts()
            it = int(diag.iterations)
            want = (only(fused_outer_step=it, galerkin_levels=1) if backend == "auto"
                    else only())
            err = infinity_norm_error(state.u, state.v, mesh, int(RE))
            runs[f"{backend}_{tol:g}"] = dict(
                iterations=it, converged=bool(diag.converged),
                final_residual=float(diag.final_residual), wall_s=wall,
                ms_per_step=wall * 1e3 / max(it, 1), ghia_infinity_error=err,
                launches=launches, launches_expected=want, launches_ok=launches == want)
            ok &= launches == want and bool(diag.converged)
        k, want_it = runs[f"auto_{tol:g}"]["iterations"], JAX_ITERATIONS_HEADLINE[tol]
        ok &= abs(k - want_it) <= max(2, 0.02 * want_it)
        if tol == 1e-3:
            c = runs["composed_0.001"]["iterations"]
            ok &= abs(k - c) <= max(2, 0.02 * c)
    ok &= runs["auto_1e-05"]["ghia_infinity_error"] < 0.10
    return dict(phase="headline", grid=NH, re=RE, runs=runs,
                profile=profile_window(
                    lambda: solve_headline(dev, "auto", 0.0, max_iterations=20), 20), ok=ok)


@contextlib.contextmanager
def fmg_parts():
    """Time the parts of the 63^2 FMG step on the host, and keep their
    arguments: K7 (``solvers.momentum.bicgstab_momentum``), K5 and K4 (the
    names ``solvers.multigrid`` calls) and the composed FMG bootstrap
    (``multigrid._fmg``).  Yields ``{part: [host ms, calls, [args, ...]]}``
    (the host clock inside each call, which enqueues and does not wait)."""
    from naviflow_tpu_torch.solvers import momentum, multigrid

    parts, saved = {}, []
    for module, name, part in ((momentum, "bicgstab_momentum", "K7"),
                               (multigrid, "fused_mg_solve", "K5"),
                               (multigrid, "galerkin_levels", "K4"),
                               (multigrid, "_fmg", "fmg_bootstrap")):
        real = getattr(module, name)
        entry = parts[part] = [0.0, 0, []]

        def timed(*a, _real=real, _entry=entry, **k):
            t0 = time.perf_counter()
            out = _real(*a, **k)
            _entry[0] += (time.perf_counter() - t0) * 1e3
            _entry[1] += 1
            _entry[2].append((a, k))
            return out

        setattr(module, name, timed)
        saved.append((module, name, real))
    try:
        yield parts
    finally:
        for module, name, real in saved:
            setattr(module, name, real)


def fmg_split(dev, steps=FMG_STEPS, replayed=4):
    """Where a 63^2 FMG step's time goes: one kernel run of ``steps`` steps
    with ``fmg_parts`` (host ms per step inside K7's, K5's and K4's wrappers
    and the composed bootstrap, and the rest: the host clock of the run
    less those), then the device ms per step of each part from its
    recorded calls replayed behind device-side sleeps (``device_busy``; the
    bootstrap from its first ``replayed`` calls)."""
    from naviflow_tpu_torch.ops import krylov, mg
    from naviflow_tpu_torch.solvers import multigrid

    with fmg_parts() as parts:
        _, _, wall = solve_headline(dev, "auto", 0.0, cycle_type="fmg", max_iterations=steps)
    wall_ms = wall * 1e3 / steps
    calls = {"K7": krylov.bicgstab_momentum, "K5": mg.fused_mg_solve,
             "K4": mg.galerkin_levels, "fmg_bootstrap": multigrid._fmg}
    out = {}
    for part, (host, n, args) in parts.items():
        fn = calls[part]
        kept = args[:replayed] if part == "fmg_bootstrap" else args
        busy, _ = device_busy(lambda: [fn(*a, **k) for a, k in kept])
        out[part] = dict(calls_per_step=n / steps, host_ms_per_step=host / steps,
                         device_ms_per_step=busy / len(kept) * n / steps if kept else 0.0)
    rest = wall_ms - sum(v["host_ms_per_step"] for v in out.values())
    return dict(ms_per_step=wall_ms, parts=out, rest_host_ms_per_step=rest)


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
    profile_steps = 4
    return dict(phase="fmg", grid=NH, steps=FMG_STEPS, launches=launches,
                launches_expected=want, residual_kernel=res_k, residual_composed=res_c,
                residual_gap=gap, residual_first=float(hist[0]), residual_last=float(hist[-1]),
                finite=finite, falling=falling, ms_per_step_kernel=wall_k * 1e3 / FMG_STEPS,
                ms_per_step_composed=wall_c * 1e3 / FMG_STEPS, split=fmg_split(dev),
                profile=profile_window(
                    lambda: solve_headline(dev, "auto", 0.0, cycle_type="fmg",
                                           max_iterations=profile_steps), profile_steps),
                ok=launches == want and finite and falling and gap <= 0.05)


def large_grid_configs(backend="auto"):
    """bench.py's large-grid configuration (_bench_large_grid)."""
    from naviflow_tpu_torch.solvers import ChebyshevMomentumConfig, MultigridConfig

    mom = ChebyshevMomentumConfig(degree=4, backend=backend)
    pres = MultigridConfig(tolerance=0.0, max_cycles=1, cycle_type="v", pre_smoothing=1,
                           post_smoothing=1, coarsest_sweeps=32, coarse_rebuild_every=8,
                           backend=backend)
    return mom, pres


def peeled_strip_levels(n, pres, plane=False):
    """How many fine levels of an n^2 even-grid hierarchy run as a K2 pair
    before the first tail the fused V-cycle (K3) admits (the rule of
    solvers/multigrid._cycle0), from the gates alone.  With ``plane``, the
    finest level is K10's and the cycle below it starts at level 1."""
    import torch

    from naviflow_tpu_torch.ops import mg, strip
    from naviflow_tpu_torch.ops.stencil9 import Stencil9

    shapes = [(n, n)]
    while min(shapes[-1]) > pres.coarsest_grid_size:
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    z = torch.zeros((1, 1), dtype=torch.float32)
    levels = [(Stencil9(*(z,) * 9), shp, lvl == 0, None) for lvl, shp in enumerate(shapes)]
    if plane:
        levels = levels[1:]
    k = next(k for k in range(1, len(levels)) if mg.supports_fused(levels[k:], pres))
    return sum(strip.supports_strip(*levels[lvl][1], levels[lvl][2], pres, torch.float32)
               for lvl in range(k))


def alpha_backoffs(diag):
    """SIMPLEC's x0.95 alpha_p backoffs in a run: the steps whose max-abs
    residual rose over the previous step's."""
    h = diag.total_res_history[:diag.iterations].double()
    return int((h[1:] > h[:-1]).sum())


def run_large_grid(dev):
    """SIMPLEC, PISO, SIMPLER and SIMPLE-BiCGSTAB at 2048^2, kernels and
    composed, from rest."""
    import torch

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch import algorithms as talg
    from naviflow_tpu_torch.solvers import KrylovMomentumConfig

    mesh = nt.StructuredMesh(nx=NL, ny=NL)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=RE)
    bc = nt.lid_driven_cavity(1.0)
    _, pres = large_grid_configs()
    strips = peeled_strip_levels(NL, pres)
    # algo -> (solve, config class, K8 and K9 launches and pressure solves per step)
    cases = {"simplec": (talg.simplec_solve, talg.SIMPLECConfig, 1, 2, 1),
             "piso": (talg.piso_solve, talg.PISOConfig, 2, 2, 2),
             "simpler": (talg.simpler_solve, talg.SIMPLERConfig, 2, 4, 2),
             "simple_bicgstab": (talg.simple_solve, talg.SIMPLEConfig, 1, 0, 1)}

    def run(name, backend, steps):
        solve, cls = cases[name][:2]
        mom, pres_b = large_grid_configs(backend)
        if name == "simple_bicgstab":  # bench.py's BENCH_MOM=bicgstab
            mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=5, backend=backend)
        state = nt.initialize_state(mesh, bc, device=dev)
        torch_sync()
        reset_counts()
        t0 = time.perf_counter()
        out, diag = solve(mesh, fluid, bc, state, cls(max_iterations=steps, tolerance=0.0),
                          momentum=mom, pressure=pres_b)
        torch_sync()
        return out, diag, (time.perf_counter() - t0) * 1e3 / steps, counts()

    run("simplec", "auto", 2)  # warm-up (allocator)
    runs, ok, total = {}, True, only()
    for name, steps in LARGE_STEPS.items():
        _, k8, k9, psolves = cases[name][1:]
        state_k, diag_k, ms_k, launches = run(name, "auto", steps)
        _, diag_c, ms_c, launches_c = run(name, "composed", steps)
        want = only(fused_assembly_pair=k8 * steps, chebyshev_momentum_strips=k9 * steps,
                    strip_down=strips * psolves * steps, strip_up=strips * psolves * steps,
                    fused_vcycle=psolves * steps)
        # PISO's Jacobi corrector config has no backend switch (as in the JAX
        # package): its momentum pair takes K8 on the composed run too
        want_c = only(fused_assembly_pair=steps) if name == "piso" else only()
        hist = diag_k.total_res_history.double()
        hist_c = diag_c.total_res_history.double()
        finite = bool(torch.isfinite(hist).all()) and all(
            bool(torch.isfinite(getattr(state_k, k)).all()) for k in ("u", "v", "p"))
        # SIMPLER with this configuration falls for six steps, then turns and
        # diverges, in the JAX package as here (its one-V-cycle p_bar is
        # added unrelaxed); its check is that it falls first and follows the
        # composed run step by step
        falling = bool((hist.min() if name == "simpler" else hist[-1]) < hist[0])
        history_gap = float(((hist - hist_c).abs() / hist_c.abs()).max())
        res_k, res_c = float(diag_k.final_residual), float(diag_c.final_residual)
        gap = abs(res_k - res_c) / res_c
        row = dict(steps=steps, launches=launches, launches_expected=want,
                   launches_composed=launches_c, launches_composed_expected=want_c,
                   residual_kernel=res_k, residual_composed=res_c, residual_gap=gap,
                   history_gap=history_gap, history_kernel=hist.tolist(),
                   finite=finite, falling=falling, ms_per_step_kernel=ms_k,
                   ms_per_step_composed=ms_c)
        if name == "simplec":
            row["alpha_p_backoffs"] = dict(kernel=alpha_backoffs(diag_k),
                                           composed=alpha_backoffs(diag_c))
        row["ok"] = (launches == want and launches_c == want_c and finite and falling
                     and gap <= 0.05 and history_gap <= 0.05)
        runs[name] = row
        ok &= row["ok"]
        total = {k: total[k] + launches[k] for k in total}
    # 8 SIMPLEC steps: one with the composed coarse rebuild, seven without
    profile = profile_window(lambda: run("simplec", "auto", 8), 8)
    return dict(phase="large_grid", grid=NL, re=RE, strip_levels=strips, runs=runs,
                launches=total, profile=profile, ok=ok)


def run_algorithms63(dev):
    """SIMPLEC, PISO and SIMPLER at 63^2 with the headline configuration to
    1e-3, kernels and composed."""
    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch import algorithms as talg

    mesh, fluid, bc = cavity_case(NH)
    cases = {"simplec": (talg.simplec_solve, talg.SIMPLECConfig),
             "piso": (talg.piso_solve, talg.PISOConfig),
             "simpler": (talg.simpler_solve, talg.SIMPLERConfig)}

    def run(name, backend, max_iterations=4000):
        solve, cls = cases[name]
        mom, pres = headline_configs(backend)
        state = nt.initialize_state(mesh, bc, device=dev)
        torch_sync()
        reset_counts()
        t0 = time.perf_counter()
        _, diag = solve(mesh, fluid, bc, state, cls(max_iterations=max_iterations,
                                                    tolerance=1e-3),
                        momentum=mom, pressure=pres)
        torch_sync()
        return diag, time.perf_counter() - t0, counts()

    runs, ok, paths = {}, True, {}
    for name in cases:
        run(name, "auto", max_iterations=3)  # warm-up
        diag_k, wall_k, launches = run(name, "auto")
        diag_c, wall_c, launches_c = run(name, "composed")
        it_k, it_c = int(diag_k.iterations), int(diag_c.iterations)
        want = only(fused_outer_step=it_k, galerkin_levels=1)
        frac = 0.05 if name == "simplec" else 0.02
        jax_it = JAX_ITERATIONS_63[name]

        def near(a, b):
            return abs(a - b) <= (frac * b if name == "simplec" else max(2, frac * b))

        row = dict(iterations_kernel=it_k, iterations_composed=it_c, iterations_jax_cpu=jax_it,
                   converged=[bool(diag_k.converged), bool(diag_c.converged)],
                   final_residual_kernel=float(diag_k.final_residual),
                   final_residual_composed=float(diag_c.final_residual),
                   wall_s_kernel=wall_k, wall_s_composed=wall_c,
                   ms_per_step_kernel=wall_k * 1e3 / max(it_k, 1),
                   ms_per_step_composed=wall_c * 1e3 / max(it_c, 1),
                   launches=launches, launches_expected=want, launches_composed=launches_c)
        if name == "simplec":
            row["alpha_p_backoffs"] = dict(kernel=alpha_backoffs(diag_k),
                                           composed=alpha_backoffs(diag_c))
        row["ok"] = (launches == want and launches_c == only() and diag_k.converged
                     and diag_c.converged and near(it_k, it_c) and near(it_k, jax_it)
                     and near(it_c, jax_it))
        runs[name] = row
        ok &= row["ok"]
        paths[name] = launches
        ALGORITHMS63_ITERATIONS[name] = it_k
    return dict(phase="algorithms63", grid=NH, re=RE, tolerance=1e-3, runs=runs, ok=ok,
                paths=paths)


def run_plane(dev):
    """SIMPLE at 4096^2 (bench.py's large_grid_3, 6 steps) with the
    large-grid configuration in the colour-plane fine layout: with every
    kernel; composed; with composed momentum and the pressure kernels (K10,
    K2, K3); and with no kernel but K1's lagged carry (K1 swapped for its
    plain version, the pressure composed), the same algorithm as the
    all-kernel run; then in the interleaved layout with every kernel.  The
    kernel runs go in turns plane, interleaved, interleaved, plane."""
    import dataclasses

    import torch

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import SIMPLEConfig, simple_solve
    from naviflow_tpu_torch.solvers.momentum import lagged_rho_enabled

    mesh = nt.StructuredMesh(nx=NP, ny=NP)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=RE)
    bc = nt.lid_driven_cavity(1.0)

    def run(layout, backend="auto", pressure_backend=None, steps=PLANE_STEPS):
        mom, _ = large_grid_configs(backend)
        _, pres = large_grid_configs(pressure_backend or backend)
        pres = dataclasses.replace(pres, fine_layout=layout)
        state = nt.initialize_state(mesh, bc, device=dev)
        torch_sync()
        reset_counts()
        t0 = time.perf_counter()
        out, diag = simple_solve(mesh, fluid, bc, state,
                                 SIMPLEConfig(max_iterations=steps, tolerance=0.0),
                                 momentum=mom, pressure=pres, loop="fused")
        torch_sync()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        return out, diag.total_res_history.double(), ms, counts()

    def gaps(h, ref):
        return ((h - ref).abs() / ref.abs()).tolist()

    mom, pres = large_grid_configs()
    s = PLANE_STEPS
    k1 = lagged_rho_enabled(NP, NP, mom, fold_poisson=True, dtype=torch.float32, device=dev)
    if k1:
        momentum = dict(fused_asmcheby_pair=s)
    else:
        momentum = dict(fused_assembly_pair=s, chebyshev_momentum_strips=2 * s)
    strips = {"plane": peeled_strip_levels(NP, pres, plane=True),
              "interleaved": peeled_strip_levels(NP, pres)}
    pressure = only(plane_strip_down=s, plane_strip_up=s, strip_down=strips["plane"] * s,
                    strip_up=strips["plane"] * s, fused_vcycle=s)
    want = {"plane": {**pressure, **momentum}, "plane_pressure": pressure,
            "interleaved": only(strip_down=strips["interleaved"] * s,
                                strip_up=strips["interleaved"] * s, fused_vcycle=s, **momentum),
            "plane_composed": only(),
            # where K1's gate refuses, this run's momentum takes K8 and K9
            "plane_lagged_plain": only() if k1 else only(**momentum)}

    run("plane", steps=2)  # warm-ups (allocator)
    run("interleaved", steps=2)
    state_k, hist, ms_p1, launches = run("plane")
    _, hist_c, ms_c, launches_c = run("plane", "composed")
    _, hist_pk, ms_pk, launches_pk = run("plane", "composed", "auto")
    with plain_k1():
        _, hist_lp, ms_lp, launches_lp = run("plane", "auto", "composed")
    state_i, hist_i, ms_i1, launches_i = run("interleaved")
    _, _, ms_i2, _ = run("interleaved")
    _, _, ms_p2, _ = run("plane")
    got = {"plane": launches, "plane_pressure": launches_pk, "interleaved": launches_i,
           "plane_composed": launches_c, "plane_lagged_plain": launches_lp}
    finite = all(bool(torch.isfinite(h).all())
                 for h in (hist, hist_c, hist_pk, hist_lp, hist_i)) and all(
        bool(torch.isfinite(getattr(st, k)).all()) for st in (state_k, state_i)
        for k in ("u", "v", "p"))
    # every kernel against the same algorithm with none (K1's lagged carry
    # in both), and the pressure kernels against the composed path (the
    # momentum composed in both); lag_gap is what the lagged carry alone
    # moves, with no kernel on either side
    kernel_gap = gaps(hist, hist_lp)
    pressure_gap = gaps(hist_pk, hist_c)
    row = dict(phase="plane", grid=NP, re=RE, steps=s, strip_levels=strips, launches=launches,
               launches_by_run=got, launches_expected=want,
               final_residual={"plane_kernel": float(hist[-1]), "plane_composed": float(hist_c[-1]),
                               "plane_pressure_kernels": float(hist_pk[-1]),
                               "plane_lagged_plain": float(hist_lp[-1]),
                               "interleaved_kernel": float(hist_i[-1])},
               kernel_gap=kernel_gap, pressure_gap=pressure_gap,
               lag_gap=gaps(hist_lp, hist_c), composed_gap=gaps(hist, hist_c),
               history_plane_kernel=hist.tolist(), history_plane_composed=hist_c.tolist(),
               history_plane_pressure_kernels=hist_pk.tolist(),
               history_plane_lagged_plain=hist_lp.tolist(),
               history_interleaved_kernel=hist_i.tolist(), finite=finite,
               ms_per_step={"plane_kernel": [ms_p1, ms_p2], "plane_composed": ms_c,
                            "plane_pressure_kernels": ms_pk, "plane_lagged_plain": ms_lp,
                            "interleaved_kernel": [ms_i1, ms_i2]})
    row["ok"] = got == want and finite and max(kernel_gap) <= 1e-3 and max(pressure_gap) <= 1e-3
    row["profile"] = profile_window(lambda: run("plane", steps=3), 3)
    return row


def sequenced_configs(backend="auto"):
    """bench.py's sequenced configuration (_bench_sequenced)."""
    from naviflow_tpu_torch.algorithms import SIMPLEConfig
    from naviflow_tpu_torch.solvers import KrylovMomentumConfig, MultigridConfig

    cfg = SIMPLEConfig(max_iterations=20000, tolerance=1e-5)
    mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=25, backend=backend)
    pres = MultigridConfig(tolerance=1e-2, max_cycles=8, cycle_type="v", check_every=2,
                           coarsest_sweeps=32, coarse_rebuild_every=8, backend=backend)
    return cfg, mom, pres


def rel_gap(got, want):
    """max |got - want| / max |want|, in float64 on the CPU."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def field_gaps(got, want):
    """The relative gaps of two flow states' u, v and p: p less its mean
    and without the four corner cells, which have no face link in the
    pressure operator (their values are a null-space component that a
    smoother may move, bfloat16's by O(1), with no effect on u and v)."""
    import torch

    def connected(p):
        p = p.detach().double().cpu()
        keep = torch.ones_like(p, dtype=torch.bool)
        keep[0, 0] = keep[0, -1] = keep[-1, 0] = keep[-1, -1] = False
        return p[keep] - p[keep].mean()

    return dict(u=rel_gap(got.u, want.u), v=rel_gap(got.v, want.v),
                p=rel_gap(connected(got.p), connected(want.p)))


def sequence(dev, n, cfg, mom, pres):
    """``grid_sequence_solve`` of the n^2 Re=1000 cavity through the port
    (ladder down to 32^2, loop 'chunked:300'); returns the fine state, the
    per-level rows (iterations, converged, wall seconds, ms a step, the
    launches of each kernel, the residual history), the total seconds and
    each level's call (mesh, fluid, bc, the state it started from and the
    keywords), to replay a level's first steps."""
    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import grid_sequence_solve, simple_solve

    mesh = nt.StructuredMesh(nx=n, ny=n)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=RE_SEQ)
    bc = nt.lid_driven_cavity(1.0)
    levels, calls = [], {}

    def timed(mesh, fluid, bc, state, cfg, **kw):
        calls[mesh.nx] = (mesh, fluid, bc, state, kw)
        before = counts()
        torch_sync()
        t0 = time.perf_counter()
        out, diag = simple_solve(mesh, fluid, bc, state, cfg, **kw)
        torch_sync()
        wall = time.perf_counter() - t0
        it = int(diag.iterations)
        levels.append(dict(nx=mesh.nx, iterations=it, converged=bool(diag.converged),
                           final_residual=float(diag.final_residual), wall_s=wall,
                           ms_per_step=wall * 1e3 / max(it, 1),
                           launches={k: v - before[k] for k, v in counts().items()
                                     if v - before[k]},
                           history=diag.total_res_history[:it].double().cpu()))
        return out, diag

    torch_sync()
    t0 = time.perf_counter()
    state, _, _ = grid_sequence_solve(mesh, fluid, bc, timed, cfg, momentum=mom,
                                      pressure=pres, loop="chunked:300", device=dev)
    torch_sync()
    return state, levels, time.perf_counter() - t0, calls


def ladder_gaps(got, want):
    """Each level's relative gap of the final residual and the largest of
    its residual history's steps, and the fine states' field gaps, of two
    ``sequence`` runs of one ladder."""
    (state_g, levels_g), (state_w, levels_w) = got, want
    gaps = []
    for lg, lw in zip(levels_g, levels_w):
        hg, hw = lg["history"], lw["history"]
        gaps.append(dict(nx=lg["nx"], final_gap=abs(lg["final_residual"] - lw["final_residual"])
                         / lw["final_residual"],
                         max_step_gap=float(((hg - hw).abs() / hw.abs()).max())))
    fields = field_gaps(state_g, state_w)
    largest = max([g[k] for g in gaps for k in ("final_gap", "max_step_gap")]
                  + list(fields.values()))
    return dict(levels=gaps, fields=fields, largest=largest)


def run_sequenced(dev):
    """The grid-sequenced 1024^2 Re=1000 solve to 1e-5 (bench.py's
    BENCH_MODE=seq configuration) through the port with every kernel: each
    level's iterations, convergence, seconds and launches; the Ghia error
    of the fine state; the device's idle share over 4 fine-level steps and
    over the first 4 steps of the 32^2 and 128^2 levels.  Then the 128 -> 32
    ladder, 20 steps a level, with the kernels and composed: each level's final
    residual and every step of its history, and the fine fields, within
    ``GAP_LIMIT``; and a control (the kernels with a V-cycle tolerance of
    2e-2 in place of 1e-2) that must exceed it."""
    import dataclasses

    import torch

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import simple_solve
    from naviflow_tpu_torch.postprocessing.validation import infinity_norm_error

    cfg, mom, pres = sequenced_configs()
    reset_counts()
    state, levels, wall, calls = sequence(dev, NS, cfg, mom, pres)
    launches = counts()
    mesh = nt.StructuredMesh(nx=NS, ny=NS)
    err = infinity_norm_error(state.u, state.v, mesh, int(RE_SEQ))
    finite = all(bool(torch.isfinite(getattr(state, k)).all()) for k in ("u", "v", "p"))
    # the kernels the gates send this ladder to (K7 <= 256^2, K8 >= 384^2,
    # K5 where a whole hierarchy fits, K2 strips and the K3 tail at 512^2 and
    # 1024^2) and none of the others
    on_path = ("bicgstab_momentum", "bicgstab_momentum_grid", "fused_assembly_pair",
               "strip_down", "strip_up", "fused_vcycle", "fused_mg_solve")
    launched_ok = (all(launches[k] > 0 for k in on_path)
                   and all(v == 0 for k, v in launches.items() if k not in on_path))

    fluid = nt.FluidProperties(density=1.0, reynolds_number=RE_SEQ)
    bc = nt.lid_driven_cavity(1.0)
    steps = dataclasses.replace(cfg, max_iterations=PROFILE_STEPS, tolerance=0.0)
    profile = profile_window(
        lambda: simple_solve(mesh, fluid, bc, state, steps, momentum=mom, pressure=pres,
                             loop="chunked:300"), PROFILE_STEPS)
    # each coarse level's first steps from the state prolonged onto it
    # (its busiest: K7 and K5 run near their caps there)
    coarse_profiles = {}
    for nx in SEQ_PROFILE_LEVELS:
        m, f, b, start, kw = calls[nx]
        prof = profile_window(lambda: simple_solve(m, f, b, start, steps, **kw), PROFILE_STEPS)
        prof["ms_per_step"] = prof["window_ms"] / PROFILE_STEPS
        prof["device_busy_ms_per_step"] = prof["device_busy_ms"] / PROFILE_STEPS
        coarse_profiles[str(nx)] = prof
    del calls

    # kernels against composed on the 128 -> 32 ladder, 20 steps a level
    runs = {}
    for name, backend, tol in (("auto", "auto", pres.tolerance),
                               ("composed", "composed", pres.tolerance),
                               ("control", "auto", 2e-2)):
        c, m, p = sequenced_configs(backend)
        st, lv, w, _ = sequence(dev, SEQ_CHECK_GRID,
                                dataclasses.replace(c, max_iterations=SEQ_CHECK_STEPS), m,
                                dataclasses.replace(p, tolerance=tol))
        runs[name] = (st, lv, w)
    sound = ladder_gaps(runs["auto"][:2], runs["composed"][:2])
    control = ladder_gaps(runs["control"][:2], runs["composed"][:2])
    for lv in levels + [lv for run in runs.values() for lv in run[1]]:
        lv.pop("history")
    row = dict(phase="sequenced", grid=NS, re=RE_SEQ, tolerance=cfg.tolerance,
               loop="chunked:300", ladder=[lv["nx"] for lv in levels], levels=levels,
               wall_s=wall, ghia_infinity_error=err, finite=finite, launches=launches,
               launched_on_path=on_path, profile=profile, coarse_profiles=coarse_profiles,
               cross_check=dict(grid=SEQ_CHECK_GRID, steps_per_level=SEQ_CHECK_STEPS,
                                kernel=runs["auto"][1], composed=runs["composed"][1],
                                wall_s={k: v[2] for k, v in runs.items()}, gaps=sound,
                                limit=GAP_LIMIT, control_tolerance=2e-2, control=control,
                                control_detected=control["largest"] > GAP_LIMIT))
    row["ok"] = (all(lv["converged"] for lv in levels) and len(levels) == 6 and err < 0.10
                 and finite and launched_ok and sound["largest"] <= GAP_LIMIT
                 and control["largest"] > GAP_LIMIT)
    return row


def run_mgcg(dev):
    """SIMPLE at 1024^2, Re=1000, with multigrid-preconditioned CG pressure
    (tolerance 1e-5, one V-cycle with 2/2 smoothing and 32 coarsest sweeps
    a preconditioner application) and the sequenced run's momentum, 10
    steps from rest, with the kernels and composed: every application is a
    K2 pair per peeled level and one K3 on the tail; ms a step, the CG
    iterations of each step.  Held to the composed run: the final residual
    and the u, v, p fields within ``GAP_LIMIT``, the CG iterations' total
    within ``ITER_TOTAL_LIMIT`` (a rounding moves a step's count by up to
    3 near float32's floor at this size); a control (CG to 1e-3) must fail
    that."""
    import torch

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import SIMPLEConfig, simple_solve
    from naviflow_tpu_torch.solvers import (KrylovMomentumConfig, MGCGPressureConfig,
                                            MultigridConfig)

    mesh = nt.StructuredMesh(nx=NS, ny=NS)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=RE_SEQ)
    bc = nt.lid_driven_cavity(1.0)

    def run(backend, steps=MGCG_STEPS, tolerance=1e-5):
        mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=25, backend=backend)
        pres = MGCGPressureConfig(tolerance=tolerance, max_iterations=50, mg=MultigridConfig(
            pre_smoothing=2, post_smoothing=2, coarsest_sweeps=32, backend=backend))
        state = nt.initialize_state(mesh, bc, device=dev)
        torch_sync()
        reset_counts()
        t0 = time.perf_counter()
        out, diag = simple_solve(mesh, fluid, bc, state,
                                 SIMPLEConfig(max_iterations=steps, tolerance=0.0),
                                 momentum=mom, pressure=pres)
        torch_sync()
        return out, diag, (time.perf_counter() - t0) * 1e3 / steps, counts(), pres.mg

    def gaps(state, diag, ref_state, ref_diag):
        res, ref = float(diag.final_residual), float(ref_diag.final_residual)
        total = sum(diag.inner_iters_history[:MGCG_STEPS].tolist())
        ref_total = sum(ref_diag.inner_iters_history[:MGCG_STEPS].tolist())
        out = dict(residual_gap=abs(res - ref) / ref, fields=field_gaps(state, ref_state),
                   pcg_total=total, pcg_total_gap=abs(total - ref_total) / ref_total)
        out["ok"] = (max(out["residual_gap"], *out["fields"].values()) <= GAP_LIMIT
                     and out["pcg_total_gap"] <= ITER_TOTAL_LIMIT)
        return out

    run("auto", steps=1)  # warm-up
    state_k, diag_k, ms_k, launches, mg_cfg = run("auto")
    state_c, diag_c, ms_c, launches_c, _ = run("composed")
    state_x, diag_x, _, _, _ = run("auto", tolerance=1e-3)
    pcg = diag_k.inner_iters_history[:MGCG_STEPS].tolist()
    applications = sum(pcg) + MGCG_STEPS  # M(r0), then one an iteration
    peeled = peeled_strip_levels(NS, mg_cfg)
    want = only(fused_assembly_pair=MGCG_STEPS, strip_down=peeled * applications,
                strip_up=peeled * applications, fused_vcycle=applications)
    hist_k = diag_k.total_res_history.double()
    hist_c = diag_c.total_res_history.double()
    finite = bool(torch.isfinite(hist_k).all()) and all(
        bool(torch.isfinite(getattr(state_k, k)).all()) for k in ("u", "v", "p"))
    sound = gaps(state_k, diag_k, state_c, diag_c)
    control = gaps(state_x, diag_x, state_c, diag_c)
    return dict(phase="mgcg", grid=NS, re=RE_SEQ, steps=MGCG_STEPS, pcg_iterations=pcg,
                pcg_iterations_composed=diag_c.inner_iters_history[:MGCG_STEPS].tolist(),
                preconditioner_applications=applications, peeled_strip_levels=peeled,
                launches=launches, launches_expected=want, launches_composed=launches_c,
                k2_pairs_per_pcg_iteration=launches["strip_down"] / max(sum(pcg), 1),
                k3_per_pcg_iteration=launches["fused_vcycle"] / max(sum(pcg), 1),
                ms_per_step_kernel=ms_k, ms_per_step_composed=ms_c,
                residual_kernel=float(diag_k.final_residual),
                residual_composed=float(diag_c.final_residual), gaps=sound,
                history_gap=((hist_k - hist_c).abs() / hist_c.abs()).tolist(), finite=finite,
                limits=dict(gap=GAP_LIMIT, iter_total=ITER_TOTAL_LIMIT),
                control=dict(tolerance=1e-3, **control, detected=not control["ok"]),
                ok=launches == want and launches_c == only() and finite and sound["ok"]
                and not control["ok"])


def solver_configs(n):
    """Each newly ported pressure configuration of the solvers phase (name ->
    (pressure config, loop)), the Gauss-Seidel multigrid baseline first."""
    import dataclasses

    from naviflow_tpu_torch.solvers import (BiCGSTABPressureConfig, CGPressureConfig,
                                            DirectPressureConfig, GMRESPressureConfig,
                                            JacobiPressureConfig)

    _, gs = headline_configs()
    out = {"mg_gs": (gs, "fused")}
    # CG and BiCGSTAB reach 1e-3 within their caps at 64^2; GMRES(20) and
    # Jacobi stall far longer and stop at theirs (each iteration is host-bound)
    for cls, cap in ((CGPressureConfig, 150), (BiCGSTABPressureConfig, 150),
                     (GMRESPressureConfig, 60)):
        for pre in ("jacobi", "none"):
            out[f"{cls().kind}_{pre}"] = (cls(tolerance=1e-3, max_iterations=cap,
                                              preconditioner=pre), "fused")
    out["jacobi"] = (JacobiPressureConfig(tolerance=1e-2, max_iterations=100, check_every=10),
                     "fused")
    out["direct"] = (DirectPressureConfig(), "fused")
    for name, kw in (("mg_jacobi", dict(smoother="jacobi", omega=0.8)),
                     ("mg_chebyshev", dict(smoother="chebyshev")),
                     ("mg_bf16", dict(smoother_dtype="bfloat16")),
                     ("mg_inject", dict(restriction="inject"))):
        out[name] = (dataclasses.replace(gs, **kw), "fused")
    if n % 2:
        out["mg_cubic_rediscretize"] = (
            dataclasses.replace(gs, prolongation="cubic", coarsening="rediscretize"), "fused")
    out["loop_host"] = (gs, "host")
    out["loop_chunked7"] = (gs, "chunked:7")
    return out


def solver_controls():
    """The solvers phase's controls on the first grid (name -> (the
    configuration whose CPU float64 run it is held to, how its pressure
    configuration is changed)): CG stopped at 1e-2 in place of 1e-3, and
    Jacobi pressure with half its sweeps.  Each must fail the checks."""
    import dataclasses

    return {"cg_jacobi_tol1e-2": ("cg_jacobi", lambda p: dataclasses.replace(p, tolerance=1e-2)),
            "jacobi_half_sweeps": ("jacobi",
                                   lambda p: dataclasses.replace(p, max_iterations=50))}


def momentum_configs(n):
    """The momentum zoo of the solvers phase (name -> momentum config), run
    with the Gauss-Seidel multigrid pressure: red-black GS, GMRES and
    IDR(s) on the power-law scheme and, on the odd grid, GMRES on QUICK."""
    from naviflow_tpu_torch.solvers import (GMRESMomentumConfig, IDRSMomentumConfig,
                                            RBGSMomentumConfig)

    out = {"mom_rbgs": RBGSMomentumConfig(n_sweeps=2),
           "mom_gmres": GMRESMomentumConfig(tolerance=1e-6, max_iterations=40, restart=10),
           "mom_idrs": IDRSMomentumConfig(tolerance=1e-6, max_iterations=30, s=4)}
    if n % 2:
        out["mom_gmres_quick"] = GMRESMomentumConfig(tolerance=1e-6, max_iterations=40,
                                                     restart=10, scheme="quick")
    return out


def rbgs_large(dev, steps=RBGS_LARGE_STEPS):
    """SIMPLE at 1024^2 with red-black GS momentum and bench.py's large-grid
    pressure: the assembly gate (K8) admits the kind, as the JAX gate does,
    and the pressure runs K2 on the peeled levels and K3 on the tail.  Held
    step by step to the same run with composed pressure (K8 still runs: the
    momentum config has no backend)."""
    import dataclasses

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import SIMPLEConfig, simple_solve
    from naviflow_tpu_torch.solvers import RBGSMomentumConfig

    mesh, fluid, bc = cavity_case(N)
    mom = RBGSMomentumConfig(n_sweeps=2)
    _, pres = large_grid_configs()

    def run(backend):
        state = nt.initialize_state(mesh, bc, device=dev)
        torch_sync()
        reset_counts()
        t0 = time.perf_counter()
        out, diag = simple_solve(mesh, fluid, bc, state,
                                 SIMPLEConfig(max_iterations=steps, tolerance=0.0),
                                 momentum=mom, pressure=dataclasses.replace(pres, backend=backend))
        torch_sync()
        return out, diag, (time.perf_counter() - t0) * 1e3 / steps, counts()

    run("auto")  # warm-up
    sk, dk, ms_k, launches = run("auto")
    sc, dc, ms_c, launches_c = run("composed")
    peeled = peeled_strip_levels(N, pres)
    want = only(fused_assembly_pair=steps, strip_down=peeled * steps, strip_up=peeled * steps,
                fused_vcycle=steps)
    gap = history_gap(dk, dc, steps)
    out = dict(grid=N, steps=steps, launches=launches, launches_expected=want,
               launches_composed_pressure=launches_c, ms_per_step=ms_k,
               ms_per_step_composed_pressure=ms_c, history_gap=gap,
               fields=field_gaps(sk, sc), residual_first=float(dk.total_res_history[0]),
               residual_last=float(dk.total_res_history[steps - 1]))
    out["ok"] = (launches == want and launches_c == only(fused_assembly_pair=steps)
                 and gap <= GAP_LIMIT and max(out["fields"].values()) <= GAP_LIMIT)
    return out


def run_solvers(dev):
    """SIMPLE at 64^2 and 63^2, Re=100, from rest, with each newly ported
    pressure configuration (``solver_configs``, 20 steps: CG, BiCGSTAB and
    GMRES with and without Jacobi preconditioning, Jacobi and direct
    pressure, multigrid with the Jacobi, Chebyshev and bfloat16 smoothers,
    injection restriction and (63^2) rediscretized coarsening with cubic
    prolongation, and the 'host' and 'chunked:7' loops) and with each newly
    ported momentum solver (``momentum_configs``, 20 steps): each card run
    (float32) against the same run on the CPU in float64: the final
    residual and the u, v, p fields within ``GAP_LIMIT``, and the inner
    iterations of every step equal (BiCGSTAB pressure, whose count a
    rounding moves by up to 20 a step, and the GMRES and IDR(s) momentum
    runs: their total within ``ITER_TOTAL_LIMIT``); the controls
    (``solver_controls``) must fail that.  The configurations other than
    the Gauss-Seidel multigrid launch none of K2, K3, K5 and K6, and the
    Gauss-Seidel ones do.  Then ``rbgs_large`` (1024^2)."""
    import torch

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import SIMPLEConfig, simple_solve

    gs_kernels = ("strip_down", "strip_up", "fused_vcycle", "fused_mg_solve",
                  "fused_outer_step")
    head_mom, gs = headline_configs()
    runs, ok, total = {}, True, {k: 0 for k in counts()}

    def solve(mesh, fluid, bc, mom, pres, loop, where, dtype, steps):
        state = nt.initialize_state(mesh, bc, dtype=dtype, device=where)
        torch_sync()
        reset_counts()
        t0 = time.perf_counter()
        out, diag = simple_solve(mesh, fluid, bc, state,
                                 SIMPLEConfig(max_iterations=steps, tolerance=0.0),
                                 momentum=mom, pressure=pres, loop=loop)
        torch_sync()
        return out, diag, (time.perf_counter() - t0) * 1e3 / steps, counts()

    def held(name, card, cpu, steps):
        (sk, dk, _, _), (sc, dc, _, _) = card, cpu
        res_k, res_c = float(dk.final_residual), float(dc.final_residual)
        inner_k = dk.inner_iters_history[:steps].tolist()
        inner_c = dc.inner_iters_history[:steps].tolist()
        out = dict(iterations=int(dk.iterations), inner_iterations=inner_k,
                   inner_iterations_cpu=inner_c, residual_card_f32=res_k,
                   residual_cpu_f64=res_c, residual_gap=abs(res_k - res_c) / res_c,
                   fields=field_gaps(sk, sc),
                   inner_total_gap=abs(sum(inner_k) - sum(inner_c)) / sum(inner_c))
        inner_ok = (out["inner_total_gap"] <= ITER_TOTAL_LIMIT
                    if name.startswith(("bicgstab", "mom_gmres", "mom_idrs"))
                    else inner_k == inner_c)
        out["held"] = (max(out["residual_gap"], *out["fields"].values()) <= GAP_LIMIT
                       and inner_ok and out["iterations"] == steps)
        return out

    controls = {}
    for n in SOLVER_GRIDS:
        mesh, fluid, bc = cavity_case(n)
        cases = {name: (head_mom, pres, loop, SOLVER_STEPS)
                 for name, (pres, loop) in solver_configs(n).items()}
        cases.update({name: (mom, gs, "fused", MOMENTUM_STEPS)
                      for name, mom in momentum_configs(n).items()})
        for name, (mom, pres, loop, steps) in cases.items():
            card = solve(mesh, fluid, bc, mom, pres, loop, dev, torch.float32, steps)
            cpu = solve(mesh, fluid, bc, mom, pres, loop, "cpu", torch.float64, steps)
            launches = card[3]
            gs_launches = sum(launches[k] for k in gs_kernels)
            gs_ok = (gs_launches > 0 if name.startswith(("mg_gs", "loop_", "mom_"))
                     else gs_launches == 0)
            for k, v in launches.items():
                total[k] += v
            row = held(name, card, cpu, steps)
            row.update(steps=steps, ms_per_step_card=card[2], ms_per_step_cpu=cpu[2],
                       launches={k: v for k, v in launches.items() if v}, gs_kernels_ok=gs_ok,
                       ok=row["held"] and gs_ok)
            runs[f"{n}:{name}"] = row
            ok &= row["ok"]
            if n == SOLVER_GRIDS[0]:
                for cname, (base, change) in solver_controls().items():
                    if base == name:
                        c = held(base, solve(mesh, fluid, bc, mom, change(pres), loop, dev,
                                             torch.float32, steps), cpu, steps)
                        controls[f"{n}:{cname}"] = dict(c, detected=not c["held"])
                        ok &= not c["held"]
    largest = {k: max(max(r[k] if k != "fields" else max(r[k].values()) for r in runs.values()),
                      0.0) for k in ("residual_gap", "fields", "inner_total_gap")}
    large = rbgs_large(dev)
    for k, v in large["launches"].items():
        total[k] += v
    return dict(phase="solvers", grids=SOLVER_GRIDS, re=RE, steps=SOLVER_STEPS,
                momentum_steps=MOMENTUM_STEPS, runs=runs, largest=largest,
                limits=dict(gap=GAP_LIMIT, iter_total=ITER_TOTAL_LIMIT), controls=controls,
                rbgs1024=large, launches=total, ok=ok and large["ok"])


def newton_configs(scheme="quick"):
    """``benchmarks/scale_runs.py``'s QUICK Newton pipeline at its target
    Reynolds number (``run_newton_511``, ``per_re(re_target)``): the SIMPLE
    warm start (alpha_p 0.18 x 0.6, alpha_u 0.6; BiCGSTAB QUICK momentum to
    1e-6 in <= 30 iterations; V-cycles to 1e-2, <= 10, checked every 2, 48
    coarsest sweeps), then ``NewtonConfig`` (1e-5, GMRES(60) to 1e-2 in <=
    240 iterations, <= 30 steps) with the preconditioner's V-cycles to 1e-3
    (<= 12, checked every 4, 48 coarsest sweeps).  ``scheme`` is Newton's
    residual scheme (the warm start is QUICK)."""
    from naviflow_tpu_torch.algorithms import NewtonConfig, SIMPLEConfig
    from naviflow_tpu_torch.solvers import KrylovMomentumConfig, MultigridConfig

    cfg = SIMPLEConfig(max_iterations=1, tolerance=0.0, alpha_p=0.18 * 0.6, alpha_u=0.6)
    mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=30, scheme="quick")
    pres = MultigridConfig(tolerance=1e-2, max_cycles=10, cycle_type="v", check_every=2,
                           coarsest_sweeps=48)
    ncfg = NewtonConfig(tolerance=1e-5, scheme=scheme, max_newton=30, gmres_tol=1e-2,
                        gmres_restart=60, gmres_maxiter=240)
    npres = MultigridConfig(tolerance=1e-3, max_cycles=12, check_every=4, coarsest_sweeps=48)
    return cfg, mom, pres, ncfg, npres


def newton_pipeline(n, device, dtype, scheme="quick", warm=None):
    """The warm start (``NEWTON_WARM_STEPS[n]`` SIMPLE steps from rest, or
    the given state) and then ``newton_solve`` of the n^2 Re=1000 cavity;
    the launches are the Newton run's alone."""
    import dataclasses

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import newton_solve, simple_solve
    from naviflow_tpu_torch.postprocessing.validation import infinity_norm_error

    cuda = torch_device_type(device) == "cuda"
    mesh = nt.StructuredMesh(nx=n, ny=n)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=RE_N)
    bc = nt.lid_driven_cavity(1.0)
    cfg, mom, pres, ncfg, npres = newton_configs(scheme)
    out = dict(grid=n, re=RE_N, scheme=scheme, warm_steps=NEWTON_WARM_STEPS[n])
    if warm is None:
        t0 = time.perf_counter()
        warm, wdiag = simple_solve(
            mesh, fluid, bc, nt.initialize_state(mesh, bc, dtype=dtype, device=device),
            dataclasses.replace(cfg, max_iterations=NEWTON_WARM_STEPS[n]), momentum=mom,
            pressure=pres)
        if cuda:
            torch_sync()
        out.update(warm_s=time.perf_counter() - t0, warm_residual=float(wdiag.final_residual))
    reset_counts()
    t0 = time.perf_counter()
    state, diag = newton_solve(mesh, fluid, bc, warm, ncfg, pressure=npres)
    if cuda:
        torch_sync()
    wall = time.perf_counter() - t0
    out.update(newton_s=wall, launches=counts(), iterations=diag.iterations,
               converged=diag.converged, final_residual=diag.final_residual,
               history=list(diag.residual_history), gmres_iterations=diag.gmres_iterations,
               ms_per_gmres_iteration=wall * 1e3 / max(diag.gmres_iterations, 1),
               ghia_infinity_error=infinity_norm_error(state.u, state.v, mesh, int(RE_N)))
    return out, warm, state, (mesh, fluid, bc, ncfg, npres)


def torch_device_type(device):
    import torch

    return torch.device(device).type


def _newton_reference_worker(conn):
    """The 63^2 pipeline on the CPU in float64, in a spawned process: sends
    the final u, v, p (numpy), the Newton and GMRES iterations, the history
    and the timings, or the traceback of a failure."""
    import traceback

    import torch

    try:
        torch.set_num_threads(1)  # one core: the card's phases run beside it
        row, _, state, _ = newton_pipeline(NN_SMALL, "cpu", torch.float64)
        row.pop("launches")
        conn.send(dict(row, **{f: getattr(state, f).numpy() for f in ("u", "v", "p")}))
    except Exception:
        conn.send(dict(error=traceback.format_exc()))
    finally:
        conn.close()


_NEWTON_REFERENCE = []  # (process, connection) of the running reference


def start_newton_reference():
    """Start the newton phase's CPU float64 reference in a spawned process
    (no CUDA in it); :func:`newton_reference` collects it."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_newton_reference_worker, args=(send,), daemon=True)
    proc.start()
    send.close()
    _NEWTON_REFERENCE.append((proc, recv))


def newton_reference(timeout=NEWTON_REFERENCE_TIMEOUT):
    """The reference's result (started here if :func:`start_newton_reference`
    was not called); the process is joined, or killed on a timeout."""
    if not _NEWTON_REFERENCE:
        start_newton_reference()
    proc, recv = _NEWTON_REFERENCE.pop()
    try:
        if not recv.poll(timeout):
            raise RuntimeError(f"the CPU float64 Newton reference took over {timeout} s")
        out = recv.recv()
    finally:
        stop_newton_reference(proc)
    if "error" in out:
        raise RuntimeError(f"the CPU float64 Newton reference failed:\n{out['error']}")
    return out


def stop_newton_reference(proc=None):
    """Join the reference's process (terminate it if it still runs)."""
    procs = [proc] if proc is not None else [p for p, _ in _NEWTON_REFERENCE]
    for p in procs:
        p.join(timeout=5.0)
        if p.is_alive():
            p.kill()
            p.join()
    if proc is None:
        _NEWTON_REFERENCE.clear()


def run_api(dev):
    """The reference's driver pattern through the object API at 63^2,
    Re=100, with its constructors mapped onto bench.py's headline
    configuration (``MultiGridSolver`` V-cycles to 1e-2, <= 6, checked
    every 2, 8 coarsest sweeps, coarse rebuild every 8;
    ``AMGMomentumSolver`` -> BiCGSTAB to 1e-6 in <= 20): ``SimpleSolver``
    on the card (its default device) to 1e-5 with ``track_infinity_norm``
    and the chunked loop, held bit for bit to the functional
    ``simple_solve`` with the same config and loop, 568 iterations (the JAX
    package's, ``BENCH_r05.json``), K6 a step and K4 once, the Ghia error
    below 0.10, the profiler's iteration count and history; then
    ``SimplecSolver``, ``PisoSolver`` and ``SimplerSolver`` to 1e-3 in the
    iterations of the algorithms63 phase's kernel runs."""
    import dataclasses

    import torch

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch import api
    from naviflow_tpu_torch.algorithms import SIMPLEConfig, simple_solve

    mesh, fluid, _ = cavity_case(NH)
    pres = dataclasses.replace(api.MultiGridSolver(tolerance=1e-2, max_iterations=6),
                               check_every=2, coarsest_sweeps=8, coarse_rebuild_every=8)
    mom = api.AMGMomentumSolver(tolerance=1e-6, max_iterations=20)
    headline = (mom, pres) == headline_configs()

    def run_pattern(cls, tol, **kw):
        algo = cls(mesh, fluid, pres, mom, api.StandardVelocityUpdater(), alpha_p=0.3,
                   alpha_u=0.7)
        algo.set_boundary_condition("top", "velocity", {"u": 1.0})
        reset_counts()
        t0 = time.perf_counter()
        result = algo.solve(max_iterations=4000, tolerance=tol, **kw)
        return algo, result, time.perf_counter() - t0, counts()

    run_pattern(api.SimpleSolver, 1e-3)  # warm-up
    algo, result, wall, launches = run_pattern(api.SimpleSolver, 1e-5,
                                               track_infinity_norm=True, loop="chunked")
    bc = algo.bc
    state, diag = simple_solve(mesh, fluid, bc, nt.initialize_state(mesh, bc, device=dev),
                               SIMPLEConfig(alpha_p=0.3, alpha_u=0.7, max_iterations=4000,
                                            tolerance=1e-5),
                               momentum=mom, pressure=pres, loop="chunked")
    torch_sync()
    it = result.iterations
    bit_equal = (diag.iterations == it and all(
        torch.equal(getattr(algo.state, k), getattr(state, k)) for k in ("u", "v", "p"))
        and torch.equal(torch.as_tensor(result.residuals),
                        diag.total_res_history[:it].cpu()))
    inf_hist = result.get_history("infinity_norm_error")
    prof = algo.profiler
    want = only(fused_outer_step=it, galerkin_levels=1)
    simple = dict(iterations=it, iterations_jax_cpu=JAX_ITERATIONS_HEADLINE[1e-5],
                  converged=result.converged, wall_s=wall, ms_per_step=wall * 1e3 / max(it, 1),
                  profiler_total_s=prof.total_time, bit_equal_to_functional=bit_equal,
                  ghia_infinity_error=result.calculate_infinity_norm_error(),
                  infinity_norm_history=[float(x) for x in inf_hist],
                  profiler_iterations=prof.iterations,
                  profiler_history_length=len(prof.convergence_info["residual_history"]),
                  launches=launches, launches_expected=want)
    ok = (headline and bit_equal and result.converged and it == JAX_ITERATIONS_HEADLINE[1e-5]
          and launches == want and simple["ghia_infinity_error"] < 0.10
          and prof.iterations == it and simple["profiler_history_length"] == it
          and len(inf_hist) == -(-it // 400) + 1 and inf_hist[-1] < 0.10)
    others = {}
    for name, cls in (("simplec", api.SimplecSolver), ("piso", api.PisoSolver),
                      ("simpler", api.SimplerSolver)):
        _, res, w, launched = run_pattern(cls, 1e-3)
        want_it = ALGORITHMS63_ITERATIONS.get(name, JAX_ITERATIONS_63[name])
        others[name] = dict(iterations=res.iterations, iterations_algorithms63=want_it,
                            converged=res.converged, wall_s=w, launches=launched)
        ok &= (res.converged and res.iterations == want_it
               and launched == only(fused_outer_step=res.iterations, galerkin_levels=1))
    return dict(phase="api", grid=NH, re=RE, headline_configs=headline, simple=simple,
                algorithms=others, launches=launches, ok=bool(ok))


def batch_run(dev, n, res, cfg, algorithm="simple", cycle_type="v", gaps=False, singles=None):
    """``batched_cavity_solve`` of ``algorithm`` at ``n``^2 over ``res`` with
    the headline configuration (``cycle_type``) from rest, then each case's
    single solve: (state and diagnostics per case, the batch's wall seconds
    and launches, the single solves' wall seconds, per case bit-equal in u,
    v, p and ``total_res_history``; with ``gaps``, per case its equal
    iterations, the fields' and every history step's relative gaps to the
    single solve and whether the fields are bit-equal).  ``singles``: a
    dict of single solves by Reynolds number (state, diagnostics, wall
    seconds) that this call fills and reuses."""
    import torch

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch import algorithms

    solve = getattr(algorithms, f"{algorithm}_solve")
    mesh, _, bc = cavity_case(n)
    mom, pres = headline_configs(cycle_type=cycle_type)
    torch_sync()
    reset_counts()
    t0 = time.perf_counter()
    out = algorithms.batched_cavity_solve(mesh, res, bc, cfg, mom, pres, algorithm=algorithm,
                                          device=dev)
    torch_sync()
    wall = time.perf_counter() - t0
    launches = counts()
    equal, single_wall = [], 0.0
    singles = {} if singles is None else singles
    for re_, (bs, bd) in zip(res, out):
        if re_ not in singles:
            fluid = nt.FluidProperties(density=1.0, reynolds_number=re_)
            state = nt.initialize_state(mesh, bc, device=dev)
            torch_sync()
            t0 = time.perf_counter()
            ss, sd = solve(mesh, fluid, bc, state, cfg, momentum=mom, pressure=pres,
                           loop="fused")
            torch_sync()
            singles[re_] = (ss, sd, time.perf_counter() - t0)
        ss, sd, wall_one = singles[re_]
        single_wall += wall_one
        fields = all(torch.equal(getattr(bs, k), getattr(ss, k)) for k in ("u", "v", "p"))
        same = (bd.iterations == sd.iterations and fields
                and torch.equal(bd.total_res_history, sd.total_res_history))
        if gaps:
            it = sd.iterations
            same = dict(bit_equal=same, fields_bit_equal=fields,
                        iterations_equal=bd.iterations == sd.iterations,
                        field_gaps=field_gaps(bs, ss),
                        history_gap=max(rel_gap(bd.total_res_history[k], sd.total_res_history[k])
                                        for k in range(it)) if it else 0.0)
        equal.append(same)
    return out, wall, launches, single_wall, equal


def run_batch(dev):
    """``batched_cavity_solve`` (the lockstep loop, one batched K6 launch a
    step) with the headline configuration to ``BATCH_TOLERANCE``: at 63^2
    Re 100 / 400 / 1000 (``BATCH_RE``), the 8-case sweep (``BATCH_RE8``)
    and Re 100 alone, and at 255^2 four cases (``BATCH_RE_BIG``).  Each case
    bit-equal to its single ``simple_solve`` (u, v, p, ``total_res_history``)
    and converged; then SIMPLEC, PISO and SIMPLER over ``BATCH_RE`` at 63^2
    (the other K6 bodies' case axis) the same way; each batch's launches:
    ``fused_outer_step_batched`` =
    the largest iteration count, no single ``fused_outer_step``, K4 once
    (the shared setup hierarchy); the cases' iteration counts not all equal.
    Beside each batch the same cases solved one after another (wall
    seconds); ms a lockstep step at B = 1, 3 and 8 (63^2); the device's idle
    share over the 8-case loop (``profile_window``); the batched K6's max
    active clusters at 16 and 8 CTAs; the card's name and power limit."""
    from naviflow_tpu_torch import algorithms
    from naviflow_tpu_torch.algorithms import batched_cavity_solve
    from naviflow_tpu_torch.ops import step

    mom, pres = headline_configs()
    runs, ok = {}, True
    for tag, n, res, algo in (("63x1", NH, BATCH_RE[:1], "simple"),
                              ("63x3", NH, BATCH_RE, "simple"),
                              ("63x8", NH, BATCH_RE8, "simple"),
                              ("255x4", NH_BIG, BATCH_RE_BIG, "simple"),
                              ("63x3:simplec", NH, BATCH_RE, "simplec"),
                              ("63x3:piso", NH, BATCH_RE, "piso"),
                              ("63x3:simpler", NH, BATCH_RE, "simpler")):
        cfg = getattr(algorithms, f"{algo.upper()}Config")(max_iterations=BATCH_MAX_IT,
                                                           tolerance=BATCH_TOLERANCE)
        mesh, _, bc = cavity_case(n)
        batched_cavity_solve(mesh, res, bc, dataclasses.replace(cfg, max_iterations=2), mom,
                             pres, algorithm=algo, device=dev)  # warm-up: scratch, params
        out, wall, launches, single_wall, equal = batch_run(dev, n, res, cfg, algo)
        iters = [d.iterations for _, d in out]
        want = only(fused_outer_step_batched=max(iters), galerkin_levels=1)
        converged = all(bool(d.converged) for _, d in out)
        runs[tag] = dict(grid=n, algorithm=algo, reynolds=list(res), iterations=iters,
                         converged=converged,
                         final_residual=[float(d.final_residual) for _, d in out],
                         bit_equal=equal, wall_s=wall, ms_per_lockstep_step=wall * 1e3 / max(iters),
                         sequential_wall_s=single_wall,
                         sequential_ms_per_step=single_wall * 1e3 / sum(iters),
                         launches=launches, launches_expected=want)
        ok &= (all(equal) and converged and launches == want
               and (len(res) == 1 or len(set(iters)) > 1))
    ok &= len(set(runs["63x3"]["iterations"])) == len(BATCH_RE)
    mesh, _, bc = cavity_case(NH)
    cfg = algorithms.SIMPLEConfig(max_iterations=BATCH_MAX_IT, tolerance=BATCH_TOLERANCE)
    profile = profile_window(
        lambda: batched_cavity_solve(mesh, BATCH_RE8, bc, cfg, mom, pres, device=dev),
        max(runs["63x8"]["iterations"]))
    fmg = run_batch_fmg(dev)
    large = run_batch_large(dev)
    assembly = run_batch_assembly(dev)
    ok &= fmg["ok"] and large["ok"] and assembly["ok"]
    return dict(phase="batch", tolerance=BATCH_TOLERANCE, runs=runs, batch_fmg=fmg,
                batch_large=large, batch_assembly=assembly,
                launches_fmg=fmg["runs"]["63x3"]["launches"],
                launches_large=large["launches"], launches_assembly=assembly["launches"],
                ms_per_lockstep_step={str(len(r["reynolds"])): r["ms_per_lockstep_step"]
                                      for t, r in runs.items()
                                      if t in ("63x1", "63x3", "63x8")},
                idle_profile_63x8=profile,
                max_active_clusters={str(k): step.max_active_clusters("simple", k, dev)
                                     for k in (16, 8)},
                cluster_size=step.cluster_size("simple", dev), card=nvidia_smi(),
                launches=runs["63x3"]["launches"], ok=ok)


def fmg_split_batched(dev, res, steps=FMG_STEPS):
    """``fmg_split``'s host side for the vmapped FMG batch over ``res``:
    host ms a lockstep step inside the K7, K5 and K4 wrappers (their
    batching rules and batched launches) and the composed bootstrap, under
    ``torch.func.vmap``, and the rest of the run's host clock."""
    from naviflow_tpu_torch import algorithms

    mesh, _, bc = cavity_case(NH)
    mom, pres = headline_configs(cycle_type="fmg")
    cfg = algorithms.SIMPLEConfig(max_iterations=steps, tolerance=0.0)
    with fmg_parts() as parts:
        torch_sync()
        t0 = time.perf_counter()
        algorithms.batched_cavity_solve(mesh, res, bc, cfg, mom, pres, device=dev)
        torch_sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    out = {part: dict(calls_per_step=n / steps, host_ms_per_step=host / steps)
           for part, (host, n, _) in parts.items()}
    return dict(cases=len(res), ms_per_lockstep_step=wall_ms, parts=out,
                rest_host_ms_per_step=wall_ms - sum(v["host_ms_per_step"] for v in out.values()))


def run_batch_fmg(dev):
    """The FMG headline configuration (``headline_configs(cycle_type='fmg')``,
    which K6's gate refuses) batched: ``batched_cavity_solve`` takes the
    vmapped branch (``torch.func.vmap`` of the single step, K7, K5 and K4
    through their batching rules) for at most ``FMG_STEPS`` lockstep steps
    to ``BATCH_TOLERANCE``, over Re 100 alone, ``BATCH_RE`` and the 8-case
    ``BATCH_RE8``: each case's iterations equal its single solve's, and its
    fields and every step of its residual history bit-equal to it or
    within ``GAP_LIMIT``; launches: batched K7 = 2 x the lockstep steps,
    batched K5 = the steps, batched K4 = the refreshes (ceil(steps / 8)),
    single K4 = 1 (the shared setup hierarchy), nothing else.  Beside each
    batch the same cases one after another; ms a lockstep step at B = 1, 3,
    8 (the single solves shared by the runs, one a Reynolds number); the
    vmapped step's split (``fmg_split_batched``, B = 3); the idle share
    over 2 lockstep steps of the 8-case batch; the batched kernels' max
    active clusters."""
    from naviflow_tpu_torch import algorithms
    from naviflow_tpu_torch.algorithms import batched_cavity_solve
    from naviflow_tpu_torch.ops import _cuda, krylov, mg

    mom, pres = headline_configs(cycle_type="fmg")
    cfg = algorithms.SIMPLEConfig(max_iterations=FMG_STEPS, tolerance=BATCH_TOLERANCE)
    runs, ok, singles = {}, True, {}
    for tag, res in (("63x1", BATCH_RE[:1]), ("63x3", BATCH_RE), ("63x8", BATCH_RE8)):
        mesh, _, bc = cavity_case(NH)
        batched_cavity_solve(mesh, res, bc, dataclasses.replace(cfg, max_iterations=2), mom,
                             pres, device=dev)  # warm-up
        out, wall, launches, single_wall, cases = batch_run(dev, NH, res, cfg, cycle_type="fmg",
                                                            gaps=True, singles=singles)
        iters = [d.iterations for _, d in out]
        steps = max(iters)
        want = only(bicgstab_momentum_batched=2 * steps, fused_mg_solve_batched=steps,
                    galerkin_levels_batched=-(-steps // 8), galerkin_levels=1)
        held = all(c["iterations_equal"] and (c["bit_equal"] or (
            max(c["field_gaps"].values()) <= GAP_LIMIT and c["history_gap"] <= GAP_LIMIT))
            for c in cases)
        runs[tag] = dict(reynolds=list(res), iterations=iters, cases=cases,
                         final_residual=[float(d.final_residual) for _, d in out],
                         held_to_single=held, wall_s=wall,
                         ms_per_lockstep_step=wall * 1e3 / steps,
                         sequential_wall_s=single_wall,
                         sequential_ms_per_step=single_wall * 1e3 / sum(iters),
                         launches=launches, launches_expected=want)
        ok &= held and launches == want
    mesh, _, bc = cavity_case(NH)
    profile_steps = 2
    profile = profile_window(
        lambda: batched_cavity_solve(mesh, BATCH_RE8, bc,
                                     dataclasses.replace(cfg, max_iterations=profile_steps,
                                                         tolerance=0.0), mom, pres, device=dev),
        profile_steps)
    sizes = {"K7": krylov.cluster_size(dev), "K5": mg.mg_solve_cluster_size(dev),
             "K4": mg.galerkin_cluster_size(dev)}
    return dict(steps=FMG_STEPS, tolerance=BATCH_TOLERANCE, runs=runs,
                ms_per_lockstep_step={str(len(r["reynolds"])): r["ms_per_lockstep_step"]
                                      for r in runs.values()},
                sequential_ms_per_step={str(len(r["reynolds"])): r["sequential_ms_per_step"]
                                        for r in runs.values()},
                fmg_split=fmg_split_batched(dev, BATCH_RE), idle_profile_63x8=profile,
                max_active_clusters={k: {str(n): _cuda.case_max_clusters(i, n, dev)
                                         for n in (sizes[k], 8)}
                                     for i, k in enumerate(("K7", "K5", "K4"))},
                cluster_size=sizes, card=nvidia_smi(), ok=ok)


def large_batch(dev, n, res, steps, backend="auto", algorithm="simple", configs=None):
    """``batched_cavity_solve`` of ``algorithm`` with ``bench.py``'s
    large-grid configuration (``solve``'s; ``configs``: another (momentum,
    pressure) pair) at n^2 over ``res``, ``steps`` lockstep steps from rest
    (tolerance 0): per-case (state, diagnostics), ms a lockstep step, the
    launches."""
    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch import algorithms

    mom, pres = configs or large_slice_configs(backend)
    mesh, bc = nt.StructuredMesh(nx=n, ny=n), nt.lid_driven_cavity(1.0)
    cfg = getattr(algorithms, f"{algorithm.upper()}Config")(max_iterations=steps,
                                                             tolerance=0.0)
    torch_sync()
    reset_counts()
    t0 = time.perf_counter()
    out = algorithms.batched_cavity_solve(mesh, res, bc, cfg, mom, pres, algorithm=algorithm,
                                          device=dev)
    torch_sync()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return out, ms, counts()


def large_single(dev, n, re_, steps, algorithm="simple", configs=None):
    """The single solve of ``large_batch``'s configuration: (state,
    diagnostics, ms a step)."""
    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch import algorithms

    mom, pres = configs or large_slice_configs()
    mesh, bc = nt.StructuredMesh(nx=n, ny=n), nt.lid_driven_cavity(1.0)
    state = nt.initialize_state(mesh, bc, device=dev)
    solve = getattr(algorithms, f"{algorithm}_solve")
    cfg = getattr(algorithms, f"{algorithm.upper()}Config")(max_iterations=steps,
                                                             tolerance=0.0)
    torch_sync()
    t0 = time.perf_counter()
    out, diag = solve(mesh, nt.FluidProperties(density=1.0, reynolds_number=re_), bc, state,
                      cfg, momentum=mom, pressure=pres, loop="fused")
    torch_sync()
    return out, diag, (time.perf_counter() - t0) * 1e3 / steps


def held_to(bs, bd, ss, sd):
    """A batch case against a single solve: fields and history bit-equal,
    or the largest relative gap of the u, v, p fields and of a history
    step (``field_gaps``, ``rel_gap``)."""
    import torch

    fields = all(torch.equal(getattr(bs, k), getattr(ss, k)) for k in ("u", "v", "p"))
    hist = torch.equal(bd.total_res_history, sd.total_res_history)
    gaps = field_gaps(bs, ss)
    it = sd.iterations
    hgap = max(rel_gap(bd.total_res_history[k], sd.total_res_history[k]) for k in range(it))
    return dict(fields_bit_equal=fields, history_bit_equal=hist,
                iterations_equal=bd.iterations == sd.iterations,
                max_field_gap=max(gaps.values()), field_gaps=gaps, history_gap=hgap)


def batched_operators(fields):
    """Whether the composed reductions of the step round under
    ``torch.func.vmap`` as they do on one case: ``torch.mean`` (the pressure
    correction's mean, ``multigrid.py:425``), ``torch.linalg.vector_norm``
    (the residual norms) and ``torch.max`` (the Gershgorin maxima), each
    batched over ``fields`` against one call a field."""
    import torch

    x = torch.stack(fields)
    out = {}
    for name, fn in (("mean", torch.mean), ("vector_norm", torch.linalg.vector_norm),
                     ("max", torch.max)):
        batched = torch.func.vmap(fn)(x)
        out[name] = all(torch.equal(batched[k], fn(x[k])) for k in range(len(fields)))
    return out


def run_batch_large(dev):
    """``bench.py``'s large-grid SIMPLE batched (``batched_cavity_solve``'s
    vmapped branch, its even arm): at 1024^2 over ``BATCH_RE`` for
    ``BATCH_LARGE_STEPS`` lockstep steps, launches exact (batched K1 = the
    steps, batched K2a = batched K2b = 2 x the steps, batched K3 = the
    steps, nothing else: no single K1, K2 or K3); each case held to its
    single ``simple_solve`` bit for bit or within ``BATCH_LARGE_LIMIT``
    relative (fields and every history step), and a control that must fail
    that: each case against its neighbour's single solve (another Re); ms a
    lockstep step at B = 1 and 3 beside the single solves' ms a step; the
    idle share over 2 lockstep steps of the 3 cases; then the even 256^2
    8-case sweep (``BATCH_RE8``) for ``BATCH_LARGE_STEPS`` steps, where K5
    takes each whole pressure solve (its gate admits the 256^2 hierarchy
    before the V-cycle's) and K1's gate is closed (below 1024^2):
    batched K5 = the steps, nothing else, each case held to its single
    solve the same way."""
    steps = BATCH_LARGE_STEPS
    large_batch(dev, N, BATCH_RE, 2)  # warm-up: scratch, launch state
    out, ms3, launches = large_batch(dev, N, BATCH_RE, steps)
    want = only(fused_asmcheby_pair_batched=steps, strip_down_batched=2 * steps,
                strip_up_batched=2 * steps, fused_vcycle_batched=steps)
    singles = [large_single(dev, N, re_, steps) for re_ in BATCH_RE]
    cases = [held_to(bs, bd, ss, sd) for (bs, bd), (ss, sd, _) in zip(out, singles)]
    control = [held_to(bs, bd, ss, sd) for (bs, bd), (ss, sd, _)
               in zip(out, singles[1:] + singles[:1])]

    def within(c):
        return c["iterations_equal"] and ((c["fields_bit_equal"] and c["history_bit_equal"])
                                          or max(c["max_field_gap"], c["history_gap"])
                                          <= BATCH_LARGE_LIMIT)

    operators = batched_operators([bs.p for bs, _ in out])
    out1, ms1, launches1 = large_batch(dev, N, BATCH_RE[:1], steps)
    held1 = within(held_to(*out1[0], *singles[0][:2]))
    profile_steps = 2
    # the event-based idle share alone (as batch_assembly's)
    profile = profile_window(lambda: large_batch(dev, N, BATCH_RE, profile_steps),
                             profile_steps, profiler=False)
    # the even 256^2 sweep
    n8 = BATCH_LARGE_SWEEP_GRID
    large_batch(dev, n8, BATCH_RE8, 2)
    out8, ms8, launches8 = large_batch(dev, n8, BATCH_RE8, steps)
    want8 = only(fused_mg_solve_batched=steps)
    singles8 = [large_single(dev, n8, re_, steps) for re_ in BATCH_RE8]
    cases8 = [held_to(bs, bd, ss, sd) for (bs, bd), (ss, sd, _) in zip(out8, singles8)]
    ok = (launches == want and all(within(c) for c in cases)
          and not any(within(c) for c in control) and held1
          and launches1 == want and launches8 == want8
          and all(within(c) for c in cases8))
    return dict(phase="batch_large", grid=N, reynolds=list(BATCH_RE), steps=steps,
                limit=BATCH_LARGE_LIMIT, cases=cases, control_neighbour_re=control,
                batched_operators_bit_equal=operators,
                launches=launches, launches_expected=want, launches_b1=launches1,
                ms_per_lockstep_step={"1": ms1, "3": ms3},
                single_ms_per_step=[ms for _, _, ms in singles],
                sequential_ms_per_step_b3=sum(ms for _, _, ms in singles),
                idle_profile_3=profile,
                sweep=dict(grid=n8, reynolds=list(BATCH_RE8), steps=steps, cases=cases8,
                           launches=launches8, launches_expected=want8,
                           ms_per_lockstep_step=ms8,
                           single_ms_per_step=[ms for _, _, ms in singles8],
                           sequential_ms_per_step=sum(ms for _, _, ms in singles8)),
                card=nvidia_smi(), ok=bool(ok))



def batch_assembly_configs(kind):
    """The batch_assembly runs' configurations: (grid, algorithm,
    (momentum, pressure), lockstep steps, the batched launches a lockstep
    step per kernel).  ``kind``: an algorithm at 2048^2 with
    ``large_grid_configs()`` (its K8 / K9 / pressure-solve counts are
    ``run_large_grid``'s), 'plane' (``large_grid_3`` at 4096^2 in the plane
    layout) or 'rbgs' (SIMPLE with red-black GS momentum at 1024^2)."""
    import dataclasses

    import torch

    from naviflow_tpu_torch.solvers import RBGSMomentumConfig
    from naviflow_tpu_torch.solvers.momentum import lagged_rho_enabled

    mom, pres = large_grid_configs()
    if kind == "plane":
        pres = dataclasses.replace(pres, fine_layout="plane")
        strips = peeled_strip_levels(NP, pres, plane=True)
        per_step = dict(plane_strip_down_batched=1, plane_strip_up_batched=1,
                        strip_down_batched=strips, strip_up_batched=strips,
                        fused_vcycle_batched=1)
        if lagged_rho_enabled(NP, NP, mom, fold_poisson=True, dtype=torch.float32,
                              device=torch.device("cuda")):
            per_step["fused_asmcheby_pair_batched"] = 1
        else:
            per_step.update(fused_assembly_pair_batched=1, chebyshev_momentum_strips_batched=2)
        return NP, "simple", (mom, pres), BATCH_PLANE_STEPS, per_step
    if kind == "rbgs":
        strips = peeled_strip_levels(N, pres)
        return N, "simple", (RBGSMomentumConfig(), pres), BATCH_ASM_STEPS, dict(
            fused_assembly_pair_batched=1, strip_down_batched=strips,
            strip_up_batched=strips, fused_vcycle_batched=1)
    k8, k9, psolves = {"simplec": (1, 2, 1), "piso": (2, 2, 2), "simpler": (2, 4, 2)}[kind]
    strips = peeled_strip_levels(NL, pres)
    return NL, kind, (mom, pres), BATCH_ASM_STEPS, dict(
        fused_assembly_pair_batched=k8, chebyshev_momentum_strips_batched=k9,
        strip_down_batched=strips * psolves, strip_up_batched=strips * psolves,
        fused_vcycle_batched=psolves)


def run_batch_assembly(dev):
    """The vmapped branch's even arm through K8, K9 and K10 (the batch
    phase's ``batch_assembly`` part): SIMPLEC, PISO and SIMPLER at 2048^2
    with ``large_grid_configs()``, ``BATCH_ASM_STEPS`` lockstep steps;
    ``large_grid_3`` in the plane layout at 4096^2, ``BATCH_PLANE_STEPS``;
    SIMPLE with red-black GS momentum at 1024^2, ``BATCH_ASM_STEPS``; each
    over ``BATCH_RE`` (``batch_assembly_configs``).  Each run: launches
    exact (the batched kernels' per-step counts times the steps, nothing
    else: no single K1, K2, K3, K8, K9 or K10 launch and no per-case step);
    each case held to its single solve bit for bit or within
    ``BATCH_LARGE_LIMIT`` (fields and every history step) with equal
    iterations (and, SIMPLEC, equal alpha_p backoffs), and a control that
    must fail that (each case against its neighbour's single solve); ms a
    lockstep step at B = 1 and 3 beside the single solves' ms a step; the
    idle share over 2 lockstep steps of the 3 cases at 2048^2 (SIMPLEC) and
    4096^2 (plane)."""
    from naviflow_tpu_torch.algorithms import batch as tbatch

    real_per_case, per_case = tbatch._per_case, []

    def counted(steps):
        per_case.append(len(steps))
        return real_per_case(steps)

    def within(c):
        return c["iterations_equal"] and ((c["fields_bit_equal"] and c["history_bit_equal"])
                                          or max(c["max_field_gap"], c["history_gap"])
                                          <= BATCH_LARGE_LIMIT)

    runs, ok, total = {}, True, only()
    tbatch._per_case = counted
    try:
        for kind in ("simplec", "piso", "simpler", "plane", "rbgs"):
            t_run = time.perf_counter()
            n, algo, configs, steps, per_step = batch_assembly_configs(kind)
            kw = dict(algorithm=algo, configs=configs)
            large_batch(dev, n, BATCH_RE, 2, **kw)  # warm-up: scratch, launch state
            out, ms3, launches = large_batch(dev, n, BATCH_RE, steps, **kw)
            want = only(**{k: c * steps for k, c in per_step.items()})
            singles = [large_single(dev, n, re_, steps, **kw) for re_ in BATCH_RE]
            cases = [held_to(bs, bd, ss, sd) for (bs, bd), (ss, sd, _) in zip(out, singles)]
            control = [held_to(bs, bd, ss, sd) for (bs, bd), (ss, sd, _)
                       in zip(out, singles[1:] + singles[:1])]
            out1, ms1, launches1 = large_batch(dev, n, BATCH_RE[:1], steps, **kw)
            held1 = within(held_to(*out1[0], *singles[0][:2]))
            row = dict(grid=n, algorithm=algo, layout=configs[1].fine_layout,
                       momentum=configs[0].kind, steps=steps, cases=cases,
                       control_neighbour_re=control, launches=launches,
                       launches_expected=want, launches_b1=launches1,
                       ms_per_lockstep_step={"1": ms1, "3": ms3},
                       single_ms_per_step=[ms for _, _, ms in singles],
                       sequential_ms_per_step_b3=sum(ms for _, _, ms in singles))
            row["batched_operators_bit_equal"] = batched_operators([bs.p for bs, _ in out])
            ok_run = (launches == want and launches1 == want and held1
                      and all(within(c) for c in cases)
                      and not any(within(c) for c in control))
            if algo == "simplec":
                row["alpha_p_backoffs"] = dict(batch=[alpha_backoffs(bd) for _, bd in out],
                                               single=[alpha_backoffs(sd)
                                                       for _, sd, _ in singles])
                ok_run &= row["alpha_p_backoffs"]["batch"] == row["alpha_p_backoffs"]["single"]
            if kind in ("simplec", "plane"):
                profile_steps = 2
                # the event-based idle share alone: the profiler's kernel
                # breakdown of the large batches is left to a benchmark
                row["idle_profile_3"] = profile_window(
                    lambda: large_batch(dev, n, BATCH_RE, profile_steps, **kw), profile_steps,
                    profiler=False)
            row["ok"] = bool(ok_run)
            row["seconds"] = time.perf_counter() - t_run
            runs[kind] = row
            ok &= ok_run
            total = {k: total[k] + launches[k] for k in total}
            del out, singles, out1
    finally:
        tbatch._per_case = real_per_case
    ok &= not per_case
    return dict(phase="batch_assembly", reynolds=list(BATCH_RE), limit=BATCH_LARGE_LIMIT,
                runs=runs, per_case_steps=len(per_case), launches=total, card=nvidia_smi(),
                ok=bool(ok))

def cli_default_configs():
    """The command line's default momentum and pressure solvers
    (``naviflow_tpu_torch/cli.py`` ``_make_solvers``: BiCGSTAB to 1e-6 in at
    most 60 iterations, multigrid V-cycles to ``--pressure-tol`` 1e-3 in at
    most 30)."""
    from naviflow_tpu_torch.solvers import KrylovMomentumConfig, MultigridConfig

    return (KrylovMomentumConfig(tolerance=1e-6, max_iterations=60),
            MultigridConfig(tolerance=1e-3, max_cycles=30))


def batch_loop_configs():
    """The batch_loops runs: (tag, grid, (momentum, pressure)): (a) the
    command line's default at 256^2 (K7's grid form a field, K5 the whole
    pressure solve), (b) at 1024^2 (K8, the pair loop, a K2 pair a strip
    level and a K3 a cycle until the tolerance), (c) ``bench.py``'s
    sequenced configuration at its 1024^2 level, (d) the FMG headline at
    255^2 (K7's grid form, K5, K4)."""
    return (("cli256", 256, cli_default_configs()), ("cli1024", N, cli_default_configs()),
            ("sequenced1024", NS, sequenced_configs()[1:]),
            ("fmg255", NH_BIG, headline_configs(cycle_type="fmg")))


def loop_launches(tag, n, pres, diags, steps):
    """The batched launches of a batch_loops run: each kernel's batched
    calls a lockstep step; a cycle kernel's (K2, K3) once a cycle of the
    slowest case that step (``diags``' inner iterations)."""
    if n % 2:
        return only(bicgstab_momentum_batched=2 * steps, bicgstab_momentum_grid_batched=2 * steps,
                    fused_mg_solve_batched=steps, galerkin_levels_batched=-(-steps // 8),
                    galerkin_levels=1)
    if tag.endswith("256"):
        return only(bicgstab_momentum_batched=2 * steps, bicgstab_momentum_grid_batched=2 * steps,
                    fused_mg_solve_batched=steps)
    lock = sum(max(int(d.inner_iters_history[k]) for d in diags) for k in range(steps))
    strips = peeled_strip_levels(n, pres)
    return only(fused_assembly_pair_batched=steps, strip_down_batched=strips * lock,
                strip_up_batched=strips * lock, fused_vcycle_batched=lock)


def single_of(batched):
    """The single solve's launches of a batched run's expected ones: each
    batched kernel's count under its single name."""
    out = only()
    for k, v in batched.items():
        out[k.replace("_batched", "")] += v
    return out


def pair_dot_bit_equal(fields):
    """Whether the pair loop's dot (``torch.sum`` over the last two axes of
    a (2, M, N) stack) rounds under ``torch.func.vmap`` as on one case."""
    import torch

    x = torch.stack([torch.stack([f, f.flip(0)]) for f in fields])
    batched = torch.func.vmap(lambda a: torch.sum(a * a, dim=(1, 2)))(x)
    return all(torch.equal(batched[k], torch.sum(x[k] * x[k], dim=(1, 2)))
               for k in range(len(fields)))


def run_batch_loops(dev):
    """The vmapped branch with the loops that read the host run through
    ``ops/while_loop.py`` (the ``batch_loops`` phase): each of
    ``batch_loop_configs`` over ``BATCH_RE`` for ``BATCH_LOOP_STEPS``
    lockstep steps from rest (tolerance 0), and Re 100 alone beside (a) and
    (b).  Each run: launches exact (``loop_launches``: no single K7, K8, K2,
    K3 or K5 launch) and no per-case step; each case held to its single
    ``simple_solve`` (iterations and every step's inner iterations equal;
    fields and every history step bit-equal or within
    ``BATCH_LARGE_LIMIT``, with the batched operators' rounding named) and
    a control that must fail that (each case against its neighbour's single
    solve); the loops' host reads a lockstep step against the single solves'
    a step, summed; ms a lockstep step against the 3 single solves' ms a
    step, summed; the idle share over 2 lockstep steps of (b)."""
    import torch

    from naviflow_tpu_torch.algorithms import batch as tbatch
    from naviflow_tpu_torch.ops import while_loop

    real_per_case, per_case = tbatch._per_case, []

    def counted(steps):
        per_case.append(len(steps))
        return real_per_case(steps)

    def within(c):
        return c["iterations_equal"] and c["inner_iterations_equal"] and (
            (c["fields_bit_equal"] and c["history_bit_equal"])
            or max(c["max_field_gap"], c["history_gap"]) <= BATCH_LARGE_LIMIT)

    steps = BATCH_LOOP_STEPS

    def held(bs, bd, ss, sd):
        return dict(held_to(bs, bd, ss, sd), inner_iterations_equal=torch.equal(
            bd.inner_iters_history[:steps].cpu(), sd.inner_iters_history[:steps].cpu()))

    runs, ok, total = {}, True, only()
    tbatch._per_case = counted
    try:
        for tag, n, configs in batch_loop_configs():
            t_run = time.perf_counter()
            kw = dict(configs=configs)
            large_batch(dev, n, BATCH_RE, 2, **kw)  # warm-up: scratch, launch state
            while_loop.HOST_READS = 0
            out, ms3, launches = large_batch(dev, n, BATCH_RE, steps, **kw)
            reads3 = while_loop.HOST_READS / steps
            want = loop_launches(tag, n, configs[1], [d for _, d in out], steps)
            singles, single_reads, single_launches, singles_exact = [], 0, [], True
            for re_ in BATCH_RE:
                while_loop.HOST_READS = 0
                reset_counts()
                singles.append(large_single(dev, n, re_, steps, **kw))
                single_reads += while_loop.HOST_READS / steps
                launched = counts()
                single_launches.append({k: v for k, v in launched.items() if v})
                # the single step's kernels, each once where the batch runs
                # its batched one (a cycle kernel: once a cycle of its own)
                singles_exact &= launched == single_of(
                    loop_launches(tag, n, configs[1], [singles[-1][1]], steps))
            cases = [held(bs, bd, ss, sd) for (bs, bd), (ss, sd, _) in zip(out, singles)]
            control = [held(bs, bd, ss, sd) for (bs, bd), (ss, sd, _)
                       in zip(out, singles[1:] + singles[:1])]
            row = dict(grid=n, momentum=configs[0].kind, pressure_tolerance=configs[1].tolerance,
                       cycle_type=configs[1].cycle_type, steps=steps, cases=cases,
                       iterations=[int(d.iterations) for _, d in out],
                       inner_iterations=[d.inner_iters_history[:steps].tolist() for _, d in out],
                       control_neighbour_re=control, launches=launches,
                       launches_expected=want, single_launches=single_launches,
                       single_launches_exact=singles_exact,
                       loop_host_reads_per_lockstep_step=reads3,
                       single_loop_host_reads_per_step_b3=single_reads,
                       ms_per_lockstep_step={"3": ms3},
                       single_ms_per_step=[ms for _, _, ms in singles],
                       sequential_ms_per_step_b3=sum(ms for _, _, ms in singles),
                       batched_operators_bit_equal=dict(
                           batched_operators([bs.p for bs, _ in out]),
                           pair_dot=pair_dot_bit_equal([bs.p for bs, _ in out])))
            ok_run = (launches == want and singles_exact and all(within(c) for c in cases)
                      and not any(within(c) for c in control))
            if tag in ("cli256", "cli1024"):
                out1, ms1, launches1 = large_batch(dev, n, BATCH_RE[:1], steps, **kw)
                want1 = loop_launches(tag, n, configs[1], [out1[0][1]], steps)
                held1 = held(*out1[0], *singles[0][:2])
                row.update(launches_b1=launches1, launches_expected_b1=want1, case_b1=held1)
                row["ms_per_lockstep_step"]["1"] = ms1
                ok_run &= launches1 == want1 and within(held1)
            if tag == "cli1024":
                profile_steps = 2
                # the CUDA-event idle share alone (the profiler's run costs
                # seconds the script's budget does not have)
                row["idle_profile_3"] = profile_window(
                    lambda: large_batch(dev, n, BATCH_RE, profile_steps, **kw), profile_steps,
                    profiler=False)
            row["ok"] = bool(ok_run)
            row["seconds"] = time.perf_counter() - t_run
            runs[tag] = row
            ok &= ok_run
            total = {k: total[k] + launches[k] for k in total}
            del out, singles
    finally:
        tbatch._per_case = real_per_case
    ok &= not per_case
    return dict(phase="batch_loops", reynolds=list(BATCH_RE), limit=BATCH_LARGE_LIMIT,
                runs=runs, per_case_steps=len(per_case), launches=total, card=nvidia_smi(),
                ok=bool(ok))


def tangent_graph_check(warm, mesh, fluid, bc, scheme):
    """Newton's captured tangent program (one CUDA graph replay) against
    ``torch.func.jvp`` of the same residual at the warm state, along a
    seeded direction: the relative max gap."""
    import torch

    from naviflow_tpu_torch.algorithms import newton as tnewton
    from naviflow_tpu_torch.core.bc import apply_velocity_bcs

    su, sv, sp = (tuple(getattr(warm, f).shape) for f in ("u", "v", "p"))
    kw = dict(dx=mesh.dx, dy=mesh.dy, rho=fluid.get_density(), mu=fluid.get_viscosity(),
              bc=bc, scheme=scheme, su=su, sv=sv, sp=sp)
    F = tnewton.make_residual(**kw)
    w = tnewton._flatten(*apply_velocity_bcs(warm.u, warm.v, bc), warm.p)
    z = torch.randn(w.shape, generator=torch.Generator().manual_seed(SEED)).to(w)
    key = (su, sv, sp, kw["dx"], kw["dy"], kw["rho"], kw["mu"], bc, scheme, w.dtype, w.device)
    linearize = tnewton._LINEARIZATIONS.get(key) or tnewton.split_linearization(F, w)
    got = linearize(w)[1](z)
    want = torch.func.jvp(F, (w,), (z,))[1]
    torch_sync()
    return dict(rel_err=rel_gap(got, want), bit_equal=bool(torch.equal(got, want)),
                replays=tnewton.GraphedTangent.REPLAYS)


def run_newton(dev):
    """Newton-Krylov on the card: (a) ``newton_configs``' pipeline at 255^2
    QUICK Re=1000: converged to 1e-5, Ghia below 0.10, K4 once per
    linearization (the preconditioner's hierarchy) and K5 once per
    preconditioner application (GMRES(m): m + 1 a restart cycle) and
    nothing else; the idle share over one Newton step from the warm start;
    (b) the same pipeline at 63^2 against the port's CPU float64 run
    (``newton_reference``): Newton iterations within ``NEWTON_ITER_SLACK``,
    u, v, p within ``GAP_LIMIT``; the control (the power-law residual in
    place of QUICK from the same warm start) must fail that.  Beside (a),
    ``tangent_graph_check``: the CUDA-graph tangent program against
    ``torch.func.jvp`` within 1e-6."""
    import dataclasses
    import types

    import torch

    from naviflow_tpu_torch.algorithms import newton_solve

    a, warm, state, (mesh, fluid, bc, ncfg, npres) = newton_pipeline(NN, dev, torch.float32)
    k = a["gmres_iterations"]
    a["launches_expected"] = only(galerkin_levels=a["iterations"],
                                  fused_mg_solve=k + k // ncfg.gmres_restart)
    a["finite"] = all(bool(torch.isfinite(getattr(state, f)).all()) for f in ("u", "v", "p"))
    a["ok"] = (a["converged"] and a["finite"] and a["ghia_infinity_error"] < 0.10
               and a["launches"] == a["launches_expected"])
    a["tangent_graph"] = tangent_graph_check(warm, mesh, fluid, bc, ncfg.scheme)
    a["ok"] &= a["tangent_graph"]["rel_err"] <= 1e-6
    # one Newton step with one GMRES(60) restart cycle (a quarter of a full
    # step's 240 iterations: the replay behind sleeps costs some 4x its host time)
    one = dataclasses.replace(ncfg, max_newton=1, gmres_maxiter=ncfg.gmres_restart)
    a["profile"] = profile_window(
        lambda: newton_solve(mesh, fluid, bc, warm, one, pressure=npres), 1, profiler=False)
    del warm, state

    ref = newton_reference()
    ref_state = types.SimpleNamespace(**{f: torch.from_numpy(ref[f]) for f in ("u", "v", "p")})
    ref_it = ref["iterations"]

    def held(row, st):
        gaps = field_gaps(st, ref_state)
        out = dict(iterations=row["iterations"], iterations_cpu_f64=ref_it, fields=gaps,
                   converged=row["converged"])
        out["held"] = (row["converged"] and abs(row["iterations"] - ref_it) <= NEWTON_ITER_SLACK
                       and max(gaps.values()) <= GAP_LIMIT)
        return out

    b, warm_b, state_b, _ = newton_pipeline(NN_SMALL, dev, torch.float32)
    b["held"] = held(b, state_b)
    b["reference"] = {k: v for k, v in ref.items() if k not in ("u", "v", "p")}
    c, _, state_c, _ = newton_pipeline(NN_SMALL, dev, torch.float32, scheme="power_law",
                                       warm=warm_b)
    c["held"] = held(c, state_c)
    ok = a["ok"] and b["held"]["held"] and not c["held"]["held"]
    return dict(phase="newton", full=a, small=b, control=dict(c, detected=not c["held"]["held"]),
                limits=dict(gap=GAP_LIMIT, iterations=NEWTON_ITER_SLACK),
                launches=a["launches"], ok=ok)


def quick_configs(backend="auto", vcycle_tol=1e-2):
    """``benchmarks/scale_runs.py``'s 511^2 QUICK configuration
    (``run_highre_511(scheme='quick')``) at Re=1000: BiCGSTAB momentum to
    1e-6 in <= 30 iterations, V-cycles to ``vcycle_tol`` (<= 10, checked
    every 2, 48 coarsest sweeps)."""
    from naviflow_tpu_torch.algorithms import SIMPLEConfig
    from naviflow_tpu_torch.solvers import KrylovMomentumConfig, MultigridConfig

    cfg = SIMPLEConfig(max_iterations=QUICK_STEPS, tolerance=0.0, alpha_p=QUICK_ALPHA_P,
                       alpha_u=0.7)
    mom = KrylovMomentumConfig(tolerance=1e-6, max_iterations=30, scheme="quick",
                               backend=backend)
    pres = MultigridConfig(tolerance=vcycle_tol, max_cycles=10, cycle_type="v", check_every=2,
                           coarsest_sweeps=48, backend=backend)
    return cfg, mom, pres


def gate_launches(n, pres, steps, cycles):
    """The launches the kernel gates admit for ``steps`` plain-V-cycle
    multigrid solves (no coarse carry) of ``cycles`` cycles in all on an
    n^2 float32 vertex hierarchy, with composed momentum: K4 a step from the
    first level its gate takes, then K5 a step where the fused gate takes the
    whole hierarchy, else per cycle a K3 on the first tail it takes and a K2
    pair per peeled level the strip gate takes."""
    import torch

    from naviflow_tpu_torch.ops import mg, strip
    from naviflow_tpu_torch.ops.stencil9 import Stencil9
    from naviflow_tpu_torch.solvers.multigrid import _level_transfers, _tail_start

    shapes = [(n, n)]
    while min(shapes[-1]) > pres.coarsest_grid_size:
        shapes.append(_level_transfers(*shapes[-1], pres)[2])
    z = torch.zeros(1)
    levels = [(Stencil9(*([z] * 9)), shp, k == 0, None) for k, shp in enumerate(shapes)]
    want = {"galerkin_levels": steps * any(mg.supports_fused_rap(*shp, pres, torch.float32)
                                           for shp in shapes[:-1])}
    if mg.supports_fused(levels, pres):
        want["fused_mg_solve"] = steps
    else:
        k = _tail_start(levels, pres)
        if k is not None:
            want["fused_vcycle"] = cycles
            peeled = sum(strip.supports_strip(*shp, k_ == 0, pres, torch.float32)
                         for k_, (_, shp, _, _) in enumerate(levels[:k]))
            want["strip_down"] = want["strip_up"] = peeled * cycles
    return only(**want)


def history_gap(diag, ref, steps):
    """The largest relative gap of two runs' per-step residuals."""
    h = diag.total_res_history[:steps].double().cpu()
    r = ref.total_res_history[:steps].double().cpu()
    return float(((h - r).abs() / r.abs()).max())


def run_quick(dev):
    """The 9-point QUICK path on one device, float32.

    (a) ``benchmarks/scale_runs.py``'s 511^2 QUICK configuration at Re=1000
    from rest for 40 steps (``quick_configs``), with the kernels and with
    ``backend='composed'``: the launches exactly what the gates admit
    (``gate_launches``: K4 a step and K3 a cycle; no K1, K6, K7, K8 or K9:
    every gate refuses 9-point momentum); every step's residual and the u,
    v, p fields within ``GAP_LIMIT`` of the composed run; the control (the
    same run with LUDS in place of QUICK) must fail that.  The V-cycles to
    2e-2 are run and their gaps reported beside: on this path no looser
    inner solve reached the limit on the CPU (V-cycles to 2e-2: 2.4e-4;
    BiCGSTAB capped at 5 iterations: 2.8e-4; 2 coarsest sweeps: 9.2e-4).
    ms a step and the device's idle share over 4 steps.
    (b) 63^2 Re=100 QUICK with the JAX package's QUICK test momentum
    (BiCGSTAB to 1e-9, <= 150 iterations) and the headline's V-cycle
    pressure, to 1e-5: converged, Ghia's infinity error below 0.10, K4 at
    the carry's builds and K5 a step; then LUDS to 1e-3."""
    import torch

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import SIMPLEConfig, simple_solve
    from naviflow_tpu_torch.postprocessing.validation import infinity_norm_error
    from naviflow_tpu_torch.solvers import KrylovMomentumConfig

    mesh = nt.StructuredMesh(nx=NQ, ny=NQ)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=RE_Q)
    bc = nt.lid_driven_cavity(1.0)

    def run(backend="auto", vcycle_tol=1e-2, steps=QUICK_STEPS, scheme="quick"):
        cfg, mom, pres = quick_configs(backend, vcycle_tol)
        cfg = dataclasses.replace(cfg, max_iterations=steps)
        mom = dataclasses.replace(mom, scheme=scheme)
        state = nt.initialize_state(mesh, bc, device=dev)
        torch_sync()
        reset_counts()
        t0 = time.perf_counter()
        out, diag = simple_solve(mesh, fluid, bc, state, cfg, momentum=mom, pressure=pres)
        torch_sync()
        return out, diag, (time.perf_counter() - t0) * 1e3 / steps, counts()

    def gaps(state, diag, ref_state, ref_diag):
        out = dict(history=history_gap(diag, ref_diag, QUICK_STEPS),
                   fields=field_gaps(state, ref_state))
        out["ok"] = max(out["history"], *out["fields"].values()) <= GAP_LIMIT
        return out

    run(steps=1)  # warm-up
    state_k, diag_k, ms_k, launches = run()
    state_c, diag_c, ms_c, launches_c = run("composed")
    state_x, diag_x, _, _ = run(scheme="luds")
    state_y, diag_y, _, _ = run(vcycle_tol=2e-2)
    cycles = diag_k.inner_iters_history[:QUICK_STEPS].tolist()
    want = gate_launches(NQ, quick_configs()[2], QUICK_STEPS, sum(cycles))
    hist = diag_k.total_res_history[:QUICK_STEPS].double()
    finite = bool(torch.isfinite(hist).all()) and all(
        bool(torch.isfinite(getattr(state_k, k)).all()) for k in ("u", "v", "p"))
    sound, control = gaps(state_k, diag_k, state_c, diag_c), gaps(state_x, diag_x, state_c, diag_c)
    looser = gaps(state_y, diag_y, state_c, diag_c)
    full = dict(grid=NQ, re=RE_Q, steps=QUICK_STEPS, alpha_p=QUICK_ALPHA_P, scheme="quick",
                launches=launches, launches_expected=want, launches_composed=launches_c,
                vcycles=cycles, ms_per_step_kernel=ms_k, ms_per_step_composed=ms_c,
                residual_first=float(hist[0]), residual_last=float(hist[-1]),
                residual_composed=float(diag_c.final_residual), finite=finite, gaps=sound,
                control=dict(scheme="luds", **control, detected=not control["ok"]),
                vcycle_tolerance_2e_2=looser,
                profile=profile_window(lambda: run(steps=PROFILE_STEPS), PROFILE_STEPS,
                                       profiler=False))
    full["ok"] = (launches == want and launches_c == only() and finite and sound["ok"]
                  and not control["ok"])

    mesh_s, fluid_s, bc_s = cavity_case(NH)
    _, pres_s = headline_configs()
    small = {}
    for scheme, tol in (("quick", 1e-5), ("luds", 1e-3)):
        mom = KrylovMomentumConfig(tolerance=1e-9, max_iterations=150, scheme=scheme)
        state = nt.initialize_state(mesh_s, bc_s, device=dev)
        torch_sync()
        reset_counts()
        t0 = time.perf_counter()
        out, diag = simple_solve(mesh_s, fluid_s, bc_s, state,
                                 SIMPLEConfig(max_iterations=4000, tolerance=tol),
                                 momentum=mom, pressure=pres_s)
        torch_sync()
        wall = time.perf_counter() - t0
        it = int(diag.iterations)
        c = counts()
        want_s = only(galerkin_levels=1 + math.ceil(it / pres_s.coarse_rebuild_every),
                      fused_mg_solve=it)
        err = infinity_norm_error(out.u, out.v, mesh_s, int(RE))
        row = dict(tolerance=tol, iterations=it, converged=bool(diag.converged),
                   final_residual=float(diag.final_residual), wall_s=wall,
                   ms_per_step=wall * 1e3 / max(it, 1), ghia_infinity_error=err,
                   launches=c, launches_expected=want_s)
        row["ok"] = bool(diag.converged) and c == want_s and (scheme != "quick" or err < 0.10)
        small[scheme] = row
    return dict(phase="quick", full=full, small=dict(grid=NH, re=RE, **small),
                launches=launches, launches_small=small["quick"]["launches"],
                ok=full["ok"] and all(r["ok"] for r in small.values()))


def dist_config(steps, **kw):
    from naviflow_tpu_torch.parallel.dist_simple import DistributedConfig

    return DistributedConfig(max_iterations=steps, tolerance=0.0, check_every=steps, **kw)


def run_distributed(dev):
    """The distributed solver (``parallel/``) on a 1x1 mesh over NCCL in
    one process (``init_process_group('nccl', store=HashStore())``, world
    size 1, destroyed when the phase ends; no fallback).

    (c) bench.py's ``_distributed_check``: 64^2, 5 steps of SIMPLE and of
    SIMPLEC (alpha_p 0.3), Jacobi momentum (2 sweeps), Jacobi-PCG pressure
    (1e-6, <= 200), against the port's single-device ``simple_solve`` /
    ``simplec_solve`` (``loop='fused'``): max |du|, |dv| below 1e-4.
    (d) 1024^2, 10 steps of SIMPLE, Chebyshev momentum (degree 6), MGCG
    pressure (1e-6, <= 60; one V-cycle of 2/2 GS, 32 coarsest sweeps, the
    levels above 32^2 on the mesh): held to the single-device SIMPLE with
    ``ChebyshevMomentumConfig(degree=6, merged_assembly='off')`` and that
    MGCG (the same algorithm, ``tests/test_torch_distributed.py``; K1's
    lagged bounds would not be) at ``GAP_LIMIT`` on every step's residual
    and the fields, CG totals within ``ITER_TOTAL_LIMIT``; a control (CG to
    1e-2) must fail that.  ms a step, CG iterations a step, collectives a
    step by kind, the device's idle share; no kernel launches on this
    path."""
    import torch
    import torch.distributed as dist

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import (SIMPLECConfig, SIMPLEConfig, simple_solve,
                                               simplec_solve)
    from naviflow_tpu_torch.parallel import decompose
    from naviflow_tpu_torch.parallel.dist_simple import distributed_simple_solve
    from naviflow_tpu_torch.parallel.sharding import make_device_mesh
    from naviflow_tpu_torch.solvers import (CGPressureConfig, ChebyshevMomentumConfig,
                                            JacobiMomentumConfig, MGCGPressureConfig,
                                            MultigridConfig)

    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        backend = dist.get_backend()
        rm = make_device_mesh(device=dev)
        lap("init")
        mesh, fluid, bc = cavity_case(NB)
        bench = {}
        for algo, single, single_cfg in (
                ("simple", simple_solve, SIMPLEConfig(max_iterations=BENCH_DIST_STEPS,
                                                      tolerance=0.0)),
                ("simplec", simplec_solve, SIMPLECConfig(max_iterations=BENCH_DIST_STEPS,
                                                         tolerance=0.0, alpha_p=0.3))):
            fd, dd = distributed_simple_solve(
                mesh, fluid, bc, nt.initialize_state(mesh, bc, device=dev), rm,
                dist_config(BENCH_DIST_STEPS, momentum_sweeps=2, pressure_solver="cg",
                            pressure_tol=1e-6, pressure_max_iter=200, algorithm=algo))
            fs, _ = single(mesh, fluid, bc, nt.initialize_state(mesh, bc, device=dev),
                           single_cfg, momentum=JacobiMomentumConfig(n_sweeps=2),
                           pressure=CGPressureConfig(tolerance=1e-6, max_iterations=200),
                           loop="fused")
            diff = max(float((fd.u - fs.u).abs().max()), float((fd.v - fs.v).abs().max()))
            bench[algo] = dict(max_uv_diff=diff, final_residual=dd["final_residual"],
                               ok=math.isfinite(diff) and diff < BENCH_DIST_LIMIT)
        lap("bench_check")

        mesh, _, bc = cavity_case(ND)
        steps = DIST_STEPS

        def run_dist(pressure_tol=1e-6, n=steps):
            state = nt.initialize_state(mesh, bc, device=dev)
            torch_sync()
            reset_counts()
            decompose.reset_collectives()
            t0 = time.perf_counter()
            out, diag = distributed_simple_solve(
                mesh, fluid, bc, state, rm,
                dist_config(n, momentum_solver="chebyshev", momentum_degree=6,
                            pressure_solver="mgcg", pressure_tol=pressure_tol,
                            pressure_max_iter=60, gather_cutoff=32))
            torch_sync()
            return (out, diag, (time.perf_counter() - t0) * 1e3 / n, counts(),
                    dict(decompose.COLLECTIVES))

        def run_single():
            state = nt.initialize_state(mesh, bc, device=dev)
            torch_sync()
            reset_counts()
            t0 = time.perf_counter()
            out, diag = simple_solve(
                mesh, fluid, bc, state, SIMPLEConfig(max_iterations=steps, tolerance=0.0),
                momentum=ChebyshevMomentumConfig(degree=6, merged_assembly="off"),
                pressure=MGCGPressureConfig(tolerance=1e-6, max_iterations=60, mg=MultigridConfig(
                    pre_smoothing=2, post_smoothing=2, coarsest_sweeps=32)))
            torch_sync()
            return out, diag, (time.perf_counter() - t0) * 1e3 / steps, counts()

        def held(state, diag, ref_state, ref_diag):
            res = torch.tensor(diag["step_residuals"][:steps], dtype=torch.float64)
            ref = ref_diag.total_res_history[:steps].double().cpu()
            cg, cg_ref = sum(diag["inner_iterations"][:steps]), sum(
                ref_diag.inner_iters_history[:steps].tolist())
            out = dict(history=float(((res - ref).abs() / ref.abs()).max()),
                       fields=field_gaps(state, ref_state),
                       cg_total=cg, cg_total_gap=abs(cg - cg_ref) / cg_ref)
            out["ok"] = (max(out["history"], *out["fields"].values()) <= GAP_LIMIT
                         and out["cg_total_gap"] <= ITER_TOTAL_LIMIT)
            return out

        run_dist(n=1)  # warm-up
        lap("warm_up")
        state_d, diag_d, ms_d, launches_d, coll = run_dist()
        lap("distributed")
        state_s, diag_s, ms_s, launches_s = run_single()
        lap("single_device")
        state_x, diag_x, _, _, _ = run_dist(pressure_tol=1e-2)
        lap("control")
        sound = held(state_d, diag_d, state_s, diag_s)
        control = held(state_x, diag_x, state_s, diag_s)
        res = torch.tensor(diag_d["step_residuals"], dtype=torch.float64)
        finite = bool(torch.isfinite(res).all()) and all(
            bool(torch.isfinite(getattr(state_d, k)).all()) for k in ("u", "v", "p"))
        full = dict(grid=ND, re=RE, steps=steps, mesh=list(rm.shape), ms_per_step=ms_d,
                    ms_per_step_single_device=ms_s,
                    cg_iterations=diag_d["inner_iterations"],
                    cg_iterations_single_device=diag_s.inner_iters_history[:steps].tolist(),
                    collectives=coll, collectives_per_step={k: v / steps for k, v in coll.items()},
                    launches=launches_d, launches_single_device=launches_s,
                    residual_first=float(res[0]), residual_last=float(res[-1]), finite=finite,
                    gaps=sound, control=dict(pressure_tolerance=1e-2, **control,
                                             detected=not control["ok"]))
        full["ok"] = (finite and sound["ok"] and not control["ok"] and launches_d == only())
    finally:
        dist.destroy_process_group()
    return dict(phase="distributed", backend=backend, world_size=1, seconds_by_part=seconds,
                bench_check=dict(grid=NB, steps=BENCH_DIST_STEPS, limit=BENCH_DIST_LIMIT, **bench),
                full=full, launches=launches_d,
                ok=backend == "nccl" and all(b["ok"] for b in bench.values()) and full["ok"])


def run_multi_rank(rm):
    """The distributed solver on ``rm``'s mesh of ranks, one process a card
    (``--ranks``, under ``torchrun``): bench.py's 64^2 check (SIMPLE,
    Jacobi momentum, CG pressure, 5 steps; max |du|, |dv| < 1e-4) and the
    distributed phase's 1024^2 SIMPLE (Chebyshev momentum, MGCG, 10 steps),
    each held on rank 0 to the single-device composed run of the same
    algorithm (the 1024^2 run at ``GAP_LIMIT`` on every step and the
    fields; the CG totals are reported, not held: float32 CG to 1e-6 stops
    at its rounding floor, and a mesh of ranks sums in another order than
    one device -- 35 against 28 over 3 steps at 64^2 on a 2x2 gloo mesh,
    fields within 5e-7); every rank's state and
    diagnostics the same (gathered checksums); ms a step and collectives a
    step by kind (P2P batches now exchange halos)."""
    import torch
    import torch.distributed as dist

    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import SIMPLEConfig, simple_solve
    from naviflow_tpu_torch.parallel import decompose
    from naviflow_tpu_torch.parallel.dist_simple import distributed_simple_solve
    from naviflow_tpu_torch.solvers import (CGPressureConfig, ChebyshevMomentumConfig,
                                            JacobiMomentumConfig, MGCGPressureConfig,
                                            MultigridConfig)

    dev = rm.device
    cases = {
        "bench": (NB, BENCH_DIST_STEPS,
                  dict(momentum_sweeps=2, pressure_solver="cg", pressure_tol=1e-6,
                       pressure_max_iter=200),
                  dict(momentum=JacobiMomentumConfig(n_sweeps=2),
                       pressure=CGPressureConfig(tolerance=1e-6, max_iterations=200))),
        "mgcg": (ND, DIST_STEPS,
                 dict(momentum_solver="chebyshev", momentum_degree=6, pressure_solver="mgcg",
                      pressure_tol=1e-6, pressure_max_iter=60, gather_cutoff=32),
                 dict(momentum=ChebyshevMomentumConfig(degree=6, backend="composed"),
                      pressure=MGCGPressureConfig(tolerance=1e-6, max_iterations=60,
                                                  mg=MultigridConfig(
                                                      pre_smoothing=2, post_smoothing=2,
                                                      coarsest_sweeps=32,
                                                      backend="composed")))),
    }
    out, ok = dict(phase="multi_rank", mesh=list(rm.shape), backend=dist.get_backend(rm.group),
                   cards=[torch.cuda.get_device_name(dev)] if dev.type == "cuda" else []), True
    for name, (n, steps, dkw, skw) in cases.items():
        mesh, fluid, bc = cavity_case(n)
        torch_sync()
        decompose.reset_collectives()
        t0 = time.perf_counter()
        state, diag = distributed_simple_solve(mesh, fluid, bc,
                                               nt.initialize_state(mesh, bc, device=dev), rm,
                                               dist_config(steps, **dkw))
        torch_sync()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        coll = dict(decompose.COLLECTIVES)
        sums = torch.tensor([float(state.u.double().sum()), float(state.v.double().sum()),
                             float(state.p.double().sum()), *diag["step_residuals"],
                             *diag["inner_iterations"]], dtype=torch.float64, device=dev)
        every = decompose.gather_blocks(sums[None, :], rm).reshape(rm.size, -1)
        row = dict(grid=n, steps=steps, ms_per_step=ms, collectives=coll,
                   collectives_per_step={k: v / steps for k, v in coll.items()},
                   inner_iterations=diag["inner_iterations"],
                   ranks_agree=bool((every == every[0]).all()))
        if rm.rank == 0:
            single, sdiag = simple_solve(mesh, fluid, bc,
                                         nt.initialize_state(mesh, bc, device=dev),
                                         SIMPLEConfig(max_iterations=steps, tolerance=0.0),
                                         loop="fused", **skw)
            res = torch.tensor(diag["step_residuals"], dtype=torch.float64)
            ref = sdiag.total_res_history[:steps].double().cpu()
            cg = sum(diag["inner_iterations"])
            cg_ref = sum(sdiag.inner_iters_history[:steps].tolist())
            row.update(max_uv_diff=max(float((state.u - single.u).abs().max()),
                                       float((state.v - single.v).abs().max())),
                       history=float(((res - ref).abs() / ref.abs()).max()),
                       fields=field_gaps(state, single), cg_total=cg,
                       cg_total_single_device=cg_ref)
            row["cg_total_gap"] = abs(cg - cg_ref) / cg_ref
            row["ok"] = row["ranks_agree"] and (
                row["max_uv_diff"] < BENCH_DIST_LIMIT if name == "bench" else
                max(row["history"], *row["fields"].values()) <= GAP_LIMIT)
            ok &= row["ok"]
        out[name] = row
        decompose.psum(torch.zeros(1, device=dev), rm)  # the other ranks wait for rank 0
    out["ok"] = ok
    return out


def ranks_main() -> int:
    """``--ranks``: one rank of ``run_multi_rank`` (``torchrun
    --nproc_per_node 4 chip_smoke.py --ranks``); rank 0 prints the card
    and the result, and the exit code is rank 0's verdict on every rank."""
    import torch
    import torch.distributed as dist

    from naviflow_tpu_torch.parallel.sharding import initialize_pod, make_device_mesh

    if not initialize_pod(device="cuda"):
        print("chip_smoke --ranks: run it under torchrun with more than one process",
              file=sys.stderr)
        return 2
    try:
        rm = make_device_mesh()
        if rm.rank == 0:
            print(nvidia_smi(), flush=True)
        row = run_multi_rank(rm)
        verdict = torch.tensor([1.0 if row["ok"] else 0.0], device=rm.device)
        dist.broadcast(verdict, 0)
        if rm.rank == 0:
            emit(row)
        return 0 if float(verdict) == 1.0 else 1
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the command line (naviflow_tpu_torch.cli), called in-process

# the JAX package's command line in float32 on the CPU, ``run --nx 63 --re
# 100 --tolerance 1e-5`` (its defaults: SIMPLE, multigrid to 1e-3 in <= 30
# cycles, BiCGSTAB momentum to 1e-6 in <= 60 iterations): 568 iterations,
# Ghia 0.05474 (naviflow_tpu.cli._run_case)
JAX_ITERATIONS_CLI = 568
CLI_NX, CLI_TOL = 63, 1e-5
CLI_CKPT = ("chunked:100", 300, 600)  # the checkpointed run's loop, then its resume's budget
CLI_SWEEP_RE = ("100", "400", "1000")
CLI_SEQ_NX, CLI_SEQ_TOL = 255, 1e-4
CLI_NEWTON = ("--nx", "63", "--re", "1000", "--scheme", "quick", "--max-iterations", "200")
CLI_DIST = ("--nx", "64", "--max-iterations", "50")
WALL_KEYS = ("wall_seconds", "wall_seconds_batch", "batched")


def cli_call(argv):
    """``naviflow_tpu_torch.cli.main(argv)`` in-process on the card: its exit
    code, the JSON objects it printed, and the host's seconds."""
    import contextlib
    import io

    from naviflow_tpu_torch import cli

    buf = io.StringIO()
    torch_sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    torch_sync()
    wall = time.perf_counter() - t0
    return rc, [json.loads(line) for line in buf.getvalue().splitlines()], wall


def cli_direct(argv, dev):
    """The CLI's mesh, fluid, boundary conditions, configs and initial state
    for ``argv``, built as a user calling the functional API would."""
    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch import cli

    args = cli._build_parser().parse_args(list(argv))
    mom, pres = cli._make_solvers(args)
    cfg_cls, solve = cli._algorithm(args)
    cfg = cfg_cls(alpha_p=args.alpha_p, alpha_u=args.alpha_u,
                  max_iterations=args.max_iterations, tolerance=args.tolerance)
    nx = args.nx if isinstance(args.nx, int) else args.nx[0]  # sweep: the first case
    mesh = nt.StructuredMesh(nx=nx, ny=nx)
    re = args.re if isinstance(args.re, float) else args.re[0]
    fluid = nt.FluidProperties(density=1.0, reynolds_number=re)
    bc = nt.lid_driven_cavity(1.0)
    return dict(args=args, mom=mom, pres=pres, cfg=cfg, solve=solve, mesh=mesh, fluid=fluid,
                bc=bc, state=lambda: nt.initialize_state(mesh, bc, device=dev))


def no_wall(row):
    return {k: v for k, v in row.items() if k not in WALL_KEYS}


def same_arrays(saved, state, names=("u", "v", "p")):
    import numpy as np

    return all(np.array_equal(saved[k], getattr(state, k).detach().cpu().numpy())
               for k in names)


def cli_run_default(dev, tmp):
    """(a) ``run`` with the CLI's defaults at 63^2 to 1e-5, saved to .npz,
    and (b) again saved to .vtk: both summaries the same, the .npz fields
    and history bit-equal to the direct ``simple_solve`` with
    ``_make_solvers``' configs, the .vtk text that of the direct result,
    the same launches (K6 a step where its gate admits the configs)."""
    import os

    import numpy as np
    import torch

    from naviflow_tpu_torch.io import exporters
    from naviflow_tpu_torch.ops.step import supports_fused_step
    from naviflow_tpu_torch.postprocessing.result import SimulationResult, result_from_solve

    argv = ("run", "--nx", str(CLI_NX), "--re", "100", "--tolerance", str(CLI_TOL))
    npz, vtk = os.path.join(tmp, "a.npz"), os.path.join(tmp, "a.vtk")
    reset_counts()
    rc, out, wall = cli_call(argv + ("--save", npz))
    launches = counts()
    reset_counts()
    rc_b, out_b, wall_b = cli_call(argv + ("--save", vtk))
    launches_b = counts()
    d = cli_direct(argv, dev)
    gate = supports_fused_step(CLI_NX, CLI_NX, d["cfg"], d["mom"], d["pres"], torch.float32)
    reset_counts()
    torch_sync()
    t0 = time.perf_counter()
    state, diag = d["solve"](d["mesh"], d["fluid"], d["bc"], d["state"](), d["cfg"],
                             momentum=d["mom"], pressure=d["pres"], loop=d["args"].loop)
    torch_sync()
    direct_s = time.perf_counter() - t0
    direct = counts()
    s = out[-1]
    it = int(diag.iterations)
    saved = np.load(npz)
    bit_equal = (s["iterations"] == it and same_arrays(saved, state) and np.array_equal(
        saved["residuals"], diag.total_res_history[:it].cpu().numpy()))
    reread = SimulationResult.load_solution(npz)
    want_vtk = exporters.export_vtk(result_from_solve(d["mesh"], d["fluid"], state, diag),
                                    os.path.join(tmp, "direct.vtk"))
    with open(vtk) as f, open(want_vtk) as g:
        vtk_equal = f.read() == g.read()
    want = only(fused_outer_step=it) if gate else direct
    slack = max(2, int(0.02 * JAX_ITERATIONS_CLI))
    row = dict(argv=list(argv), summary=s, k6_gate_admits=gate, wall_s=wall,
               ms_per_step=wall * 1e3 / max(it, 1), direct_s=direct_s,
               direct_ms_per_step=direct_s * 1e3 / max(it, 1),
               iterations_jax_cpu=JAX_ITERATIONS_CLI, bit_equal_to_direct=bit_equal,
               launches=launches, launches_direct=direct, launches_expected=want,
               vtk=dict(summary_equal=no_wall(out_b[-1]) == no_wall(s), text_equal=vtk_equal,
                        launches=launches_b, wall_s=wall_b),
               npz_reread_equal=bool(all(np.array_equal(getattr(reread, k), saved[k])
                                         for k in ("u", "v", "p"))))
    row["ok"] = bool(rc == 0 and rc_b == 0 and len(out) == len(out_b) == 1 and bit_equal
                     and launches == direct == want and launches_b == launches
                     and s["converged"] and abs(it - JAX_ITERATIONS_CLI) <= slack
                     and s["infinity_norm_error"] < 0.10 and row["vtk"]["summary_equal"]
                     and vtk_equal and row["npz_reread_equal"])
    return row


def cli_checkpoints(dev, tmp):
    """(c) ``--checkpoint-dir`` with ``CLI_CKPT``'s loop for its first
    budget, then ``--resume`` to its second: the kept ``step_*``
    directories, each bit-equal to the direct chunked run's state at that
    iteration (the first run's to the uninterrupted run's, the resumed
    run's to the direct run from the loaded checkpoint, as the CLI resumes
    it; the resumed checkpoints' gap to the uninterrupted run is reported)."""
    import dataclasses
    import os

    import torch

    from naviflow_tpu_torch.io.checkpoint import load_checkpoint

    loop, first, total = CLI_CKPT
    ck = os.path.join(tmp, "ckpt")
    base = ("run", "--nx", str(CLI_NX), "--re", "100", "--tolerance", str(CLI_TOL),
            "--loop", loop, "--checkpoint-dir", ck)
    d = cli_direct(base, dev)

    def direct_run(state, budget, offset):
        snaps = {}

        def keep(it, total_res, carry):
            snaps[offset + it] = tuple(carry[k].clone() for k in ("u", "v", "p"))

        _, diag = d["solve"](d["mesh"], d["fluid"], d["bc"], state,
                             dataclasses.replace(d["cfg"], max_iterations=budget),
                             momentum=d["mom"], pressure=d["pres"], loop=loop, on_chunk=keep)
        torch_sync()
        return snaps, int(diag.iterations)

    def steps():
        return sorted(x for x in os.listdir(ck) if x.startswith("step_"))

    def check(names, snaps):
        out = {}
        for name in names:
            st, it, hist, _ = load_checkpoint(os.path.join(ck, name), device=dev)
            want = snaps.get(it)
            out[name] = dict(iteration=it, history_length=int(hist["total"].numel()),
                             bit_equal=want is not None and all(
                                 torch.equal(getattr(st, k), w)
                                 for k, w in zip(("u", "v", "p"), want)))
        return out

    reset_counts()
    rc1, out1, wall1 = cli_call(base + ("--max-iterations", str(first)))
    launches1 = counts()
    names1 = steps()
    uninterrupted, it_full = direct_run(d["state"](), total, 0)
    kept1 = check(names1, uninterrupted)
    resume_from = load_checkpoint(os.path.join(ck, names1[-1]), device=dev)
    reset_counts()
    rc2, out2, wall2 = cli_call(base + ("--max-iterations", str(total), "--resume"))
    launches2 = counts()
    names2 = steps()
    resumed, it_resumed = direct_run(resume_from[0], total - resume_from[1], resume_from[1])
    # a checkpoint of the first run may still be kept after the resume
    kept2 = check(names2, {**{i: s for i, s in uninterrupted.items() if i <= first}, **resumed})
    for name, c in kept2.items():
        full = uninterrupted.get(c["iteration"])
        if full is not None and c["iteration"] > first:
            st = load_checkpoint(os.path.join(ck, name), device=dev)[0]
            c["gap_to_uninterrupted"] = {k: rel_gap(getattr(st, k), w)
                                         for k, w in zip(("u", "v", "p"), full)}
    n1, n2 = out1[-1]["iterations"], out2[-1]["iterations"]
    row = dict(loop=loop, budgets=[first, total], first=dict(names=names1, checkpoints=kept1,
                                                             iterations=n1, wall_s=wall1,
                                                             launches=launches1),
               resumed=dict(names=names2, checkpoints=kept2, iterations=n2, from_iteration=
                            resume_from[1], direct_iterations=it_resumed, wall_s=wall2,
                            converged=out2[-1]["converged"], launches=launches2),
               uninterrupted_iterations=it_full)
    row["ok"] = bool(rc1 == 0 and rc2 == 0 and n1 == first and resume_from[1] == first
                     and len(names1) == 2 and len(names2) == 2
                     and all(c["bit_equal"] for c in (*kept1.values(), *kept2.values()))
                     and n2 == it_resumed and names2[-1] == f"step_{first + n2:08d}"
                     and launches1 == only(fused_outer_step=n1)
                     and launches2 == only(fused_outer_step=n2))
    return row


def cli_sweep(dev, tmp):
    """(d) ``sweep`` over ``CLI_SWEEP_RE`` at 63^2 to 1e-3, case by case and
    with ``--vmap``: the rows (apart from wall times) equal to each other
    and to a direct ``batched_cavity_solve`` with the CLI's configs; case by
    case K6 a step of every case, with ``--vmap`` (and the direct call) one
    batched K6 launch a lockstep step."""
    import os

    from naviflow_tpu_torch.algorithms import batched_cavity_solve

    argv = ("sweep", "--nx", str(CLI_NX), "--re", *CLI_SWEEP_RE, "--tolerance", "1e-3")
    runs = {}
    for tag, extra in (("each", ()), ("vmap", ("--vmap",))):
        reset_counts()
        rc, rows, wall = cli_call(argv + extra + ("--out", os.path.join(tmp, tag)))
        runs[tag] = dict(rc=rc, rows=rows, wall_s=wall, launches=counts())
    d = cli_direct(argv, dev)
    res = [float(r) for r in CLI_SWEEP_RE]
    reset_counts()
    direct = batched_cavity_solve(d["mesh"], res, d["bc"], d["cfg"], d["mom"], d["pres"],
                                  device=dev)
    torch_sync()
    direct_launches = counts()
    cases = [dict(re=re, iterations=int(dg.iterations), converged=bool(dg.converged),
                  final_residual=float(dg.final_residual)) for re, (_, dg) in zip(res, direct)]
    each, vmap = runs["each"]["rows"], runs["vmap"]["rows"]
    rows_equal = [no_wall(a) for a in each] == [no_wall(b) for b in vmap]
    direct_equal = all(r["iterations"] == c["iterations"] and r["converged"] == c["converged"]
                       and r["final_residual"] == c["final_residual"]
                       for rows in (each, vmap) for r, c in zip(rows, cases))
    iters = [c["iterations"] for c in cases]
    want = {"each": only(fused_outer_step=sum(iters)),
            "vmap": only(fused_outer_step_batched=max(iters))}
    row = dict(argv=list(argv), rows=vmap, direct=cases, rows_equal=rows_equal,
               direct_equal=direct_equal, wall_s={k: r["wall_s"] for k, r in runs.items()},
               launches={k: r["launches"] for k, r in runs.items()},
               launches_direct=direct_launches, launches_expected=want)
    row["ok"] = bool(all(r["rc"] == 0 for r in runs.values()) and len(each) == len(vmap)
                     == len(res) and rows_equal and direct_equal
                     and all(r["launches"] == want[k] for k, r in runs.items())
                     and direct_launches == want["vmap"])
    return row


def cli_sequence(dev):
    """(e) ``run --sequence`` at 255^2 to 1e-4: converged, Ghia below 0.10,
    the launches and the result of a direct ``grid_sequence_solve`` with
    the CLI's configs."""
    import torch

    from naviflow_tpu_torch.algorithms import grid_sequence_solve

    argv = ("run", "--sequence", "--nx", str(CLI_SEQ_NX), "--tolerance", str(CLI_SEQ_TOL))
    reset_counts()
    rc, out, wall = cli_call(argv)
    launches = counts()
    d = cli_direct(argv, dev)
    reset_counts()
    t0 = time.perf_counter()
    _, diag, levels = grid_sequence_solve(d["mesh"], d["fluid"], d["bc"], d["solve"], d["cfg"],
                                          momentum=d["mom"], pressure=d["pres"],
                                          loop=d["args"].loop, dtype=torch.float32, device=dev)
    torch_sync()
    direct_s = time.perf_counter() - t0
    direct = counts()
    s = out[-1]
    row = dict(argv=list(argv), summary=s, levels=levels, wall_s=wall, direct_s=direct_s,
               launches=launches, launches_direct=direct,
               direct_final_residual=float(diag.final_residual))
    row["ok"] = bool(rc == 0 and s["converged"] and s["infinity_norm_error"] < 0.10
                     and launches == direct and s["iterations"] == int(diag.iterations)
                     and s["final_residual"] == float(diag.final_residual))
    return row


def cli_newton(dev):
    """(f) ``run --newton`` on 63^2 QUICK Re=1000 from 200 SIMPLE steps:
    SIMPLE short of the tolerance, Newton converged.  Launches: the SIMPLE
    steps' (the QUICK momentum composed, so each step builds its hierarchy
    with one K4 and solves with one K5, as the CLI's multigrid config
    passes both gates at 63^2), then Newton's: K4 one a Newton step and
    K5 one a preconditioner application (GMRES(m): m + 1 a restart cycle),
    nothing else."""
    from naviflow_tpu_torch.algorithms import NewtonConfig

    argv = ("run",) + CLI_NEWTON + ("--newton",)
    reset_counts()
    rc, out, wall = cli_call(argv)
    launches = counts()
    s = out[-1]
    steps = cli_direct(argv, dev)["cfg"].max_iterations
    k = s.get("newton_gmres_iterations", 0)
    newton = s.get("newton_iterations", -1)
    want = only(galerkin_levels=steps + newton,
                fused_mg_solve=steps + k + k // NewtonConfig().gmres_restart)
    row = dict(argv=list(argv), summary=s, wall_s=wall, launches=launches,
               launches_expected=want, simple_steps=steps,
               ms_per_gmres_iteration_upper=wall * 1e3 / max(k, 1))
    row["ok"] = bool(rc == 0 and s["iterations"] == steps and s.get("newton_converged")
                     and s["converged"] and launches == want)
    return row


def cli_distributed(dev, tmp):
    """(g) ``run --distributed`` on 64^2 (50 steps) on the single rank:
    the saved fields and the iterations equal to a direct
    ``distributed_simple_solve`` with the CLI's mapped config on the
    one-rank mesh; no kernel launch, as in the JAX package."""
    import os

    import numpy as np

    from naviflow_tpu_torch import cli
    from naviflow_tpu_torch.parallel.dist_simple import distributed_simple_solve
    from naviflow_tpu_torch.parallel.sharding import make_device_mesh

    npz = os.path.join(tmp, "dist.npz")
    argv = ("run", "--distributed") + CLI_DIST
    reset_counts()
    rc, out, wall = cli_call(argv + ("--save", npz))
    launches = counts()
    d = cli_direct(argv, dev)
    reset_counts()
    final, diag = distributed_simple_solve(d["mesh"], d["fluid"], d["bc"], d["state"](),
                                           make_device_mesh(device=dev),
                                           cli._distributed_config(d["args"]))
    torch_sync()
    direct = counts()
    s = out[-1]
    equal = same_arrays(np.load(npz), final) and s["iterations"] == diag["iterations"]
    row = dict(argv=list(argv), summary=s, wall_s=wall, equal_to_direct=equal,
               launches=launches, launches_direct=direct)
    row["ok"] = bool(rc == 0 and equal and s["device_mesh"] == {"x": 1, "y": 1}
                     and launches == direct == only())
    return row


def cli_mg_debug(dev):
    """(h) ``debug_vcycle`` bit-equal to the composed ``_cycle`` on the 63^2
    vertex, 256^2 and 1024^2 cell-centred hierarchies, with 6 stages a
    non-coarsest level and one for the coarsest; its final iterate against
    ``_cycle0`` on the card (K3 on the first two, K2 strips and a K3 tail at
    1024^2) within the kernel phase's K3 (1e-5 of the output) and K2
    (``strip_close``) tolerances.  These launches compare and do not join
    the phase's."""
    import dataclasses

    import torch

    from naviflow_tpu_torch.solvers.multigrid import _cycle, _cycle0
    from naviflow_tpu_torch.utils.mg_debug import debug_vcycle

    inp = odd_inputs(NH, dev, steps=5)
    pres = dataclasses.replace(inp["pres"], backend="auto")  # odd_inputs' is composed
    levels1024, cfg1024, _ = fine_levels(dev)
    even_levels, even_b = even_hierarchy(256, dev, pres)
    rng = torch.Generator(device=dev).manual_seed(SEED)
    b1024 = torch.randn(N, N, generator=rng, device=dev)
    out, ok = {}, True
    for label, levels, b, cfg, k2 in (("vertex63", inp["levels"], inp["b"], pres, False),
                                      ("cell256", even_levels, even_b, pres, False),
                                      ("cell1024", levels1024, b1024 - b1024.mean(), cfg1024,
                                       True)):
        p0 = torch.zeros_like(b)
        want = _cycle(p0, b, levels, 0, cfg)
        got, stages = debug_vcycle(p0, b, levels, cfg)
        reset_counts()
        kern = _cycle0(p0, b, levels, cfg)
        torch_sync()
        launched = counts()
        a, r = max_err(kern, got)
        close = strip_close(kern, got) if k2 else r < 1e-5
        n = len(levels)
        row = dict(levels=[lv[1][0] for lv in levels], stages=len(stages),
                   bit_equal=bool(torch.equal(got, want)), kernel_max_abs_err=a,
                   kernel_rel_err=r, kernel_close=close, launches=launched)
        row["ok"] = (row["bit_equal"] and len(stages) == 6 * (n - 1) + 1 and close
                     and launched["fused_vcycle"] == 1
                     and launched["strip_down"] == launched["strip_up"] == (2 if k2 else 0))
        out[label] = row
        ok &= row["ok"]
    return dict(hierarchies=out, ok=bool(ok))


def cli_examples(dev):
    """(i) ``operator_sanity`` and ``cavity_basic``'s ``run(args)`` on the
    card, the latter to 1e-3 at 63^2 Re=100: the operator checks pass, the
    solve converges and is finite."""
    import contextlib
    import io

    import numpy as np

    from naviflow_tpu_torch.examples import cavity_basic, operator_sanity
    from naviflow_tpu_torch.examples._common import parse

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = operator_sanity.run(operator_sanity.parse(["--device", "cuda"]))
        reset_counts()
        t0 = time.perf_counter()
        result = cavity_basic.run(parse(argv=["--tolerance", "1e-3"]))
        wall = time.perf_counter() - t0
    launches = counts()
    finite = all(bool(np.isfinite(getattr(result, k)).all()) for k in ("u", "v", "p"))
    row = dict(operator_sanity=rows, cavity_basic=dict(
        iterations=result.iterations, converged=result.converged, wall_s=wall,
        ghia_infinity_error=result.calculate_infinity_norm_error(), finite=finite),
        printed=buf.getvalue().splitlines(), launches=launches)
    row["ok"] = bool(all(r["ok"] for r in rows) and result.converged and finite)
    return row


def run_cli(dev):
    """The command line (``naviflow_tpu_torch.cli.main``) in-process on the
    card, (a)-(g), then the multigrid debug recorder (h) and two examples
    (i); ``launches`` sums the CLI runs' and the examples' counts."""
    import tempfile

    parts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (("run", lambda: cli_run_default(dev, tmp)),
                         ("checkpoint", lambda: cli_checkpoints(dev, tmp)),
                         ("sweep", lambda: cli_sweep(dev, tmp)),
                         ("sequence", lambda: cli_sequence(dev)),
                         ("newton", lambda: cli_newton(dev)),
                         ("distributed", lambda: cli_distributed(dev, tmp)),
                         ("mg_debug", lambda: cli_mg_debug(dev)),
                         ("examples", lambda: cli_examples(dev))):
            t0 = time.perf_counter()
            parts[name] = fn()
            parts[name]["seconds"] = time.perf_counter() - t0
    launches = dict.fromkeys(counts(), 0)

    def add(c):
        for k, v in c.items():
            launches[k] += v

    r = parts
    add(r["run"]["launches"])
    add(r["run"]["vtk"]["launches"])
    add(r["checkpoint"]["first"]["launches"])
    add(r["checkpoint"]["resumed"]["launches"])
    for c in r["sweep"]["launches"].values():
        add(c)
    for name in ("sequence", "newton", "distributed", "examples"):
        add(r[name]["launches"])
    return dict(phase="cli", **parts, launches=launches,
                ok=all(p["ok"] for p in parts.values()))


# line name -> (launch counter, source, the TPU kernel's pallas_call, the path
# whose run counts its launches)
SOURCES = {
    "fused_asmcheby_pair": ("fused_asmcheby_pair", "naviflow_tpu_torch/csrc/asmcheby.cu",
                            "naviflow_tpu/ops/pallas_asmcheby.py:303", "slice"),
    "strip_down": ("strip_down", "naviflow_tpu_torch/csrc/strip.cu",
                   "naviflow_tpu/ops/pallas_strip.py:304", "slice"),
    "strip_up": ("strip_up", "naviflow_tpu_torch/csrc/strip.cu",
                 "naviflow_tpu/ops/pallas_strip.py:339", "slice"),
    "fused_vcycle": ("fused_vcycle", "naviflow_tpu_torch/csrc/mg.cu",
                     "naviflow_tpu/ops/pallas_mg.py:479", "slice"),
    "galerkin_levels": ("galerkin_levels", "naviflow_tpu_torch/csrc/mg.cu",
                        "naviflow_tpu/ops/pallas_mg.py:445", "headline"),
    "fused_mg_solve": ("fused_mg_solve", "naviflow_tpu_torch/csrc/mg.cu",
                       "naviflow_tpu/ops/pallas_mg.py:512", "fmg"),
    "bicgstab_momentum": ("bicgstab_momentum", "naviflow_tpu_torch/csrc/krylov.cu",
                          "naviflow_tpu/ops/pallas_krylov.py:142", "fmg"),
    # K7's cooperative grid form (fields past the band's shared memory):
    # the sequenced ladder's 256^2 level
    "bicgstab_momentum_grid": ("bicgstab_momentum_grid", "naviflow_tpu_torch/csrc/krylov.cuh",
                               "naviflow_tpu/ops/pallas_krylov.py:142", "sequenced"),
    "fused_simple_step": ("fused_outer_step", "naviflow_tpu_torch/csrc/step.cuh",
                          "naviflow_tpu/ops/pallas_step.py:364", "headline"),
    "fused_outer_step[simplec]": ("fused_outer_step", "naviflow_tpu_torch/csrc/step.cuh",
                                  "naviflow_tpu/ops/pallas_step.py:364",
                                  "algorithms63:simplec"),
    "fused_outer_step[piso]": ("fused_outer_step", "naviflow_tpu_torch/csrc/step.cuh",
                               "naviflow_tpu/ops/pallas_step.py:364", "algorithms63:piso"),
    "fused_outer_step[simpler]": ("fused_outer_step", "naviflow_tpu_torch/csrc/step.cuh",
                                  "naviflow_tpu/ops/pallas_step.py:364",
                                  "algorithms63:simpler"),
    # K6 with the case axis: the batch phase's lockstep loop
    "fused_outer_step_batched": ("fused_outer_step_batched", "naviflow_tpu_torch/csrc/step.cuh",
                                 "naviflow_tpu/ops/pallas_step.py:364", "batch"),
    # K7, K5 and K4 with the case axis: the batch phase's vmapped FMG step
    "bicgstab_momentum_batched": ("bicgstab_momentum_batched", "naviflow_tpu_torch/csrc/krylov.cu",
                                  "naviflow_tpu/ops/pallas_krylov.py:142", "batch_fmg"),
    "fused_mg_solve_batched": ("fused_mg_solve_batched", "naviflow_tpu_torch/csrc/mg.cu",
                               "naviflow_tpu/ops/pallas_mg.py:512", "batch_fmg"),
    "galerkin_levels_batched": ("galerkin_levels_batched", "naviflow_tpu_torch/csrc/mg.cu",
                                "naviflow_tpu/ops/pallas_mg.py:445", "batch_fmg"),
    # K7's grid form with the case axis: the batch_loops phase's runs
    "bicgstab_momentum_grid_batched": ("bicgstab_momentum_grid_batched",
                                       "naviflow_tpu_torch/csrc/krylov.cuh",
                                       "naviflow_tpu/ops/pallas_krylov.py:142", "batch_loops"),
    # K1, K2a, K2b and K3 with the case axis: the batch phase's vmapped
    # large-grid step
    "fused_asmcheby_pair_batched": ("fused_asmcheby_pair_batched",
                                    "naviflow_tpu_torch/csrc/asmcheby.cuh",
                                    "naviflow_tpu/ops/pallas_asmcheby.py:303", "batch_large"),
    "strip_down_batched": ("strip_down_batched", "naviflow_tpu_torch/csrc/strip.cu",
                           "naviflow_tpu/ops/pallas_strip.py:304", "batch_large"),
    "strip_up_batched": ("strip_up_batched", "naviflow_tpu_torch/csrc/strip.cu",
                         "naviflow_tpu/ops/pallas_strip.py:339", "batch_large"),
    "fused_vcycle_batched": ("fused_vcycle_batched", "naviflow_tpu_torch/csrc/mg.cu",
                             "naviflow_tpu/ops/pallas_mg.py:479", "batch_large"),
    # K8, K9, K10a and K10b with the case axis: the batch phase's vmapped
    # SIMPLEC / PISO / SIMPLER, plane-layout and RBGS steps
    "fused_assembly_pair_batched": ("fused_assembly_pair_batched",
                                    "naviflow_tpu_torch/csrc/assembly.cu",
                                    "naviflow_tpu/ops/pallas_assembly.py:294", "batch_assembly"),
    "chebyshev_momentum_strips_batched": ("chebyshev_momentum_strips_batched",
                                          "naviflow_tpu_torch/csrc/cheby.cu",
                                          "naviflow_tpu/ops/pallas_cheby.py:192",
                                          "batch_assembly"),
    "plane_strip_down_batched": ("plane_strip_down_batched", "naviflow_tpu_torch/csrc/plane.cu",
                                 "naviflow_tpu/ops/pallas_plane.py:266", "batch_assembly"),
    "plane_strip_up_batched": ("plane_strip_up_batched", "naviflow_tpu_torch/csrc/plane.cu",
                               "naviflow_tpu/ops/pallas_plane.py:299", "batch_assembly"),
    "fused_assembly_pair": ("fused_assembly_pair", "naviflow_tpu_torch/csrc/assembly.cu",
                            "naviflow_tpu/ops/pallas_assembly.py:294", "large_grid"),
    "chebyshev_momentum_strips": ("chebyshev_momentum_strips",
                                  "naviflow_tpu_torch/csrc/cheby.cu",
                                  "naviflow_tpu/ops/pallas_cheby.py:192", "large_grid"),
    "plane_strip_down": ("plane_strip_down", "naviflow_tpu_torch/csrc/plane.cu",
                         "naviflow_tpu/ops/pallas_plane.py:266", "plane"),
    "plane_strip_up": ("plane_strip_up", "naviflow_tpu_torch/csrc/plane.cu",
                       "naviflow_tpu/ops/pallas_plane.py:299", "plane"),
    # no path of the JAX package calls K11: its path is the kernel phase
    "rbgs_sweeps": ("rbgs_sweeps", "naviflow_tpu_torch/csrc/poisson.cu",
                    "naviflow_tpu/ops/pallas_kernels.py:121", "kernel_phase"),
    "apply_poisson": ("apply_poisson", "naviflow_tpu_torch/csrc/poisson.cu",
                      "naviflow_tpu/ops/pallas_kernels.py:138", "kernel_phase"),
}


# the strip kernels' rows: one a level, summed into one step's work
STRIP_NAMES = ("strip_down", "strip_up", "strip_down_batched", "strip_up_batched")


def kernels_line(rows, paths):
    """One entry per kernel (and per K6 body).  The time, error and work are
    those of its main-path shape (K2: both strip levels of one step, summed,
    with each level's own times and bound under ``levels`` and the launches
    a step of its path under ``launches_per_step``;
    K7 and K9: the u and v solves, averaged; K8: with the Gershgorin maxima,
    as SIMPLEC, PISO and SIMPLER call it; K10 at 4096^2; K11 at 256^2); the
    launches are those of the path that runs it (K1-K3 the 1024^2 slice, K4
    and K6's simple body the headline to 1e-3, K5 and K7 the FMG run, K8 and
    K9 the 2048^2 runs, the other K6 bodies their 63^2 runs, batched K6 the
    batch phase's 63^2 Re 100 / 400 / 1000 run (its time, error and work:
    the kernel phase's 63^2 B = 3 row, with its cases, waves and the max
    active clusters), batched K7, K5 and K4 the batch phase's FMG 63^2 Re
    100 / 400 / 1000 run (their times, errors and work: the kernel phase's
    63^2 B = 3 rows), batched K1, K2a, K2b and K3 the batch phase's
    ``batch_large`` run (theirs: the kernel phase's B = 3 rows at the
    1024^2 path's shapes, the strips' two levels summed), batched K8, K9,
    K10a and K10b the batch phase's ``batch_assembly`` runs (theirs: the
    kernel phase's B = 3 rows, K8 with the maxima at 2048^2, K9 the u and
    v fields averaged, K10 on the 4096^2 planes), K7's grid form the
    sequenced ladder (its 255^2 u and v rows), batched K7 in its grid form
    the ``batch_loops`` runs (its 256^2 B = 3 u and v rows, averaged), K10
    the 4096^2 plane run, K11 the kernel phase's
    checking calls), with every path's count beside them.  ``library_ms``:
    K11b's cuSPARSE SpMV; no other kernel's function is one PyTorch call."""
    out = []
    for name, (counter, src, replaces, path) in SOURCES.items():
        mine = [r for r in rows if r["name"] == name and r.get("main", True)
                and not r.get("vertex")]
        k = 1 if name in STRIP_NAMES else len(mine)
        ms = sum(r["ms"] for r in mine) / k
        plain_ms = sum(r["plain_ms"] for r in mine) / k
        nbytes = sum(r["work"][0] for r in mine) / k
        flops = sum(r["work"][1] for r in mine) / k
        b_ms, b_by = bound(nbytes, flops)
        lib = [r["library_ms"] for r in mine if "library_ms" in r]
        entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                     launches=paths[path][counter],
                     max_abs_err=max(r["max_abs_err"] for r in mine),
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=sum(lib) / len(lib) if lib else None,
                     launches_by_path={p: c[counter] for p, c in paths.items()},
                     bytes=nbytes, flops=flops)
        # device times (every kernel), K11b's SpMV's and launch floor, the
        # host times per call (every kernel) and the barrier bounds (K3-K7)
        for key in ("device_ms", "library_device_ms", "launch_floor_ms", "host_ms",
                    "grid_barriers", "cluster_barriers", "barrier_bound_ms", "cases",
                    "max_active_clusters", "waves"):
            if all(key in r for r in mine):
                entry[key] = sum(r[key] for r in mine) / k
        if "cases" in entry:
            entry["cases"] = mine[0]["cases"]
        if name in STRIP_NAMES:
            entry["launches_per_step"] = paths[path][counter] / (
                BATCH_LARGE_STEPS if path == "batch_large" else STEPS)
            entry["levels"] = []
            for r in mine:
                lb_ms, lb_by = bound(*r["work"])
                entry["levels"].append(dict(
                    shape=r["shape"], five_point=r["five_point"], ms=r["ms"],
                    device_ms=r["device_ms"], plain_ms=r["plain_ms"], bound_ms=lb_ms,
                    bound_by=lb_by, **({"host_ms": r["host_ms"]} if "host_ms" in r else {})))
        out.append(entry)
    return out


AB_KERNELS = ("K1", "K2a", "K2b", "K3", "K7", "K5", "K4", "K6", "K8", "K9", "K10a", "K10b",
              "K11a", "K11b", "loops")
# K11a's A/B cases (shape, sweeps) and K11b's shapes
AB_K11A = (((63, 63), 1), ((63, 63), 3), ((256, 256), 3), ((256, 256), 6))
AB_K11B = ((63, 63), (256, 256), (48, 96))


def ab_loop_runs():
    """The A/B's single solves through the loops that read the host (name,
    grid, Re, SIMPLE config, momentum, pressure): the command line's default
    solvers at 256^2 with composed BiCGSTAB (the single-field loop) and at
    1024^2 (K8 and the pair loop), both with the multigrid tolerance loop,
    and the quick phase's 511^2 QUICK configuration (the single-field loop,
    9-point), each over a few steps from rest."""
    from naviflow_tpu_torch.algorithms import SIMPLEConfig

    mom, pres = cli_default_configs()
    cfg = SIMPLEConfig(max_iterations=6, tolerance=0.0, alpha_p=0.3, alpha_u=0.7)
    qcfg, qmom, qpres = quick_configs()
    return (("composed256", 256, 400.0, cfg,
             dataclasses.replace(mom, backend="composed", batch_pair="off"), pres),
            ("pair1024", N, 400.0, cfg, mom, pres),
            ("quick511", NQ, RE_Q, dataclasses.replace(qcfg, max_iterations=10), qmom, qpres))


def ab_loops(dev, tag, saved, save):
    """The ``loops`` entry of ``ab_side``: each of ``ab_loop_runs`` after a
    2-step warm-up, three times; each run's ms a step (``ms_per_step``: the
    median), every step's inner iterations and (with ``save``) the fields
    for ``ab_compare``; then once more under ``op_counter``: the aten
    operators the host dispatches a step and its waits for the device a
    step, which the host clock's spread does not blur; then the device's
    busy ms a step and the host's ms a step spent enqueueing, without its
    waits (``device_busy``'s segments)."""
    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch.algorithms import simple_solve

    for name, n, re_, cfg, mom, pres in ab_loop_runs():
        mesh, bc = nt.StructuredMesh(nx=n, ny=n), nt.lid_driven_cavity(1.0)
        fluid = nt.FluidProperties(density=1.0, reynolds_number=re_)
        simple_solve(mesh, fluid, bc, nt.initialize_state(mesh, bc, device=dev),
                     dataclasses.replace(cfg, max_iterations=2), momentum=mom, pressure=pres)
        runs = []
        for _ in range(3):
            state = nt.initialize_state(mesh, bc, device=dev)
            torch_sync()
            t0 = time.perf_counter()
            out, diag = simple_solve(mesh, fluid, bc, state, cfg, momentum=mom, pressure=pres)
            torch_sync()
            runs.append((time.perf_counter() - t0) * 1e3 / cfg.max_iterations)
        steps = cfg.max_iterations
        def solve():
            return simple_solve(mesh, fluid, bc, nt.initialize_state(mesh, bc, device=dev), cfg,
                                momentum=mom, pressure=pres)

        with op_counter() as ops:
            solve()
        busy, spans = device_busy(solve)
        emit(dict(phase="ab", tag=tag, kernel="loops", run=name, n=n, steps=steps,
                  ms_per_step=sorted(runs)[1], ms_per_step_runs=runs,
                  device_busy_ms_per_step=busy / steps,
                  host_enqueue_ms_per_step=sum(host for _, host, _ in spans) / steps,
                  ops_per_step=ops.ops / steps, host_waits_per_step=ops.waits / steps,
                  inner_iterations=[int(k) for k in diag.inner_iters_history[:steps]],
                  residual=float(diag.total_res_history[steps - 1])))
        if save:
            saved[f"loops_{name}"] = {k: getattr(out, k).detach().cpu() for k in ("u", "v", "p")}
        del out, diag, state


def ab_side(dev, tag, kernels=AB_KERNELS, save=None, sizes=(NH, 95, 127, NH_BIG, 511)):
    """One side of an A/B between two trees, through the tree's own
    wrappers, of the ``kernels`` named: K1 at 1024^2 and 4096^2
    (``asmcheby_current``) and K2a and K2b on both strip levels of the
    1024^2 hierarchy (``fine_levels``), each output's error against the
    plain version; K7 on each n^2 cavity's u and v systems (``odd_inputs``
    from rest, maxiter 20), K5 on the 63^2 and 255^2 vertex hierarchies of
    the same states and on the 256^2 cell-centred one (the headline
    configuration), the error of the first output; K4 on the same 63^2 and
    255^2 vertex hierarchies, every output's error; K11a at ``AB_K11A`` and
    K11b at ``AB_K11B`` (``poisson_system``'s inputs); K8 at 2048^2 with the
    maxima and with the consistent fold, K9 on that state's u and v systems
    (degree 4) and K10a / K10b on the 4096^2 planes (1 / 1 sweeps), every
    output's error (``cavity_fields``, ``plane_inputs``); device, event and
    host times of each; K6's phase split (``k6_phases``: each body's RAP
    phase and event ms a step); ``loops``: the single solves of
    ``ab_loop_runs`` (``ab_loops``).  With ``save``, K1's, K2a's, K2b's,
    K4's, K5's, K7's, K8's, K9's, K10's and K11's outputs (K4: all nine
    arrays of every coarse level; K5: p, r, cycles and rel) and the loops'
    fields go to
    ``save/TAG.pt`` for ``ab_compare``.  Run it in turns A, B, B, A, each from a tree's
    root: ``PYTHONPATH=. python3 -P <this file> --ab TAG`` (``-P``: the tree
    on PYTHONPATH, not this file's directory, supplies the package)."""
    from pathlib import Path

    import torch

    from naviflow_tpu_torch.ops import asmcheby, kernels as k11, krylov, mg, strip

    saved = {}

    def timed(fn, **key):
        emit(dict(phase="ab", tag=tag, **key, ms=time_ms(fn), device_ms=device_ms(fn),
                  device_ms_again=device_ms(fn), host_ms=host_ms(fn)))

    def row(fn, plain, save_as=None, **key):
        got, want = fn(), plain()
        if save and save_as:
            outs = got if isinstance(got, tuple) else (got,)
            saved[save_as] = {f"out{k}": g.detach().cpu() for k, g in enumerate(outs)}
        got, want = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
        a, r = max_err(got, want)
        timed(fn, **key, max_abs_err=a, rel_err=r)

    def outputs(name, tensors, want):
        errs = {k: max_err(g, w)[1] for (k, g), w in zip(tensors.items(), want)}
        if save:
            saved[name] = {k: g.detach().cpu() for k, g in tensors.items()}
        return errs

    if "K1" in kernels:
        names = ("u_star", "r_u", "v_star", "r_v", "d_u", "d_v", "pe", "pw", "pn", "ps",
                 "pdiag", "rho_u", "rho_v")
        for n in (N, NP):
            fields, a = asmcheby_current(dev, n)

            def flat(out):
                pc = out[6]
                return (*out[:6], pc.a_e, pc.a_w, pc.a_n, pc.a_s, pc.diag, out[7], out[8])

            got = flat(asmcheby.fused_asmcheby_pair(*fields, **a))
            want = flat(asmcheby.fused_asmcheby_pair_plain(*fields, **a))
            errs = outputs(f"K1_{n}", dict(zip(names, got)), want)
            del got, want
            timed(lambda: asmcheby.fused_asmcheby_pair(*fields, **a), kernel="K1", n=n,
                  rel_err=errs, max_rel_err=max(errs.values()))
            del fields, a
    if "K2a" in kernels:
        levels, cfg, rng = fine_levels(dev)
        for lvl in (0, 1):
            st, (n, _), five, _ = levels[lvl]
            p, b = (torch.as_tensor(rng.normal(size=(n, n)), dtype=torch.float32, device=dev)
                    for _ in range(2))
            got = strip.strip_down(p, b, st, cfg, five)
            errs = outputs(f"K2a_{n}", dict(zip(("p", "rc"), got)),
                           strip.strip_down_plain(p, b, st, cfg, five))
            timed(lambda: strip.strip_down(p, b, st, cfg, five), kernel="K2a", n=n,
                  five_point=five, rel_err=errs, max_rel_err=max(errs.values()))
        del levels
    if "K2b" in kernels:
        levels, cfg, rng = fine_levels(dev)
        for lvl in (0, 1):
            st, (n, _), five, _ = levels[lvl]
            p, b, ec = (torch.as_tensor(rng.normal(size=shp), dtype=torch.float32, device=dev)
                        for shp in ((n, n), (n, n), (n // 2, n // 2)))
            errs = outputs(f"K2b_{n}", {"p": strip.strip_up(p, b, st, ec, cfg, five)},
                           [strip.strip_up_plain(p, b, st, ec, cfg, five)])
            timed(lambda: strip.strip_up(p, b, st, ec, cfg, five), kernel="K2b", n=n,
                  five_point=five, rel_err=errs, max_rel_err=max(errs.values()))
        del levels
    if "K3" in kernels:
        levels, cfg, rng = fine_levels(dev)
        tail = levels[2:]
        n = tail[0][1][0]
        b = torch.as_tensor(rng.normal(size=(n, n)), dtype=torch.float32, device=dev)
        p = torch.zeros_like(b)
        errs = outputs(f"K3_{n}", {"p": mg.fused_vcycle(p, b, tail, cfg)},
                       [mg.fused_vcycle_plain(p, b, tail, cfg)])
        timed(lambda: mg.fused_vcycle(p, b, tail, cfg), kernel="K3", n=n, rel_err=errs,
              max_rel_err=max(errs.values()))
        del levels, tail
    # K7 at every size, K5 and K4 on the 63^2 and 255^2 hierarchies
    if "K7" in kernels:
        odd_sizes = sizes
    elif {"K5", "K4"} & set(kernels):
        odd_sizes = (NH, NH_BIG)
    else:
        odd_sizes = ()
    for n in odd_sizes:
        inp = odd_inputs(n, dev, steps=0)
        for field in ("u", "v") if "K7" in kernels else ():
            x0, c = inp[field], inp["c" + field]
            row(lambda: krylov.bicgstab_momentum(x0, c, tol=1e-6, maxiter=20),
                lambda: krylov.bicgstab_momentum_plain(x0, c, tol=1e-6, maxiter=20),
                save_as=f"K7_{n}_{field}", kernel="K7", n=n, field=field, shape=list(x0.shape))
        if n in (NH, NH_BIG) and "K5" in kernels:
            cases = [(f"vertex{n}", inp["levels"], inp["b"])]
            if n == NH_BIG:
                cases.append(("cell256", *even_hierarchy(256, dev, inp["pres"])))
            for label, levels, b in cases:
                p0 = torch.zeros_like(b)
                row(lambda: mg.fused_mg_solve(p0, b, levels, inp["pres"]),
                    lambda: mg.fused_mg_solve_plain(p0, b, levels, inp["pres"]),
                    save_as=f"K5_{label}", kernel="K5", hierarchy=label)
        if n in (NH, NH_BIG) and "K4" in kernels:
            fine, shapes = inp["levels"][0][0], [lv[1] for lv in inp["levels"]]
            names = ("c", "e", "w", "n", "s", "ne", "nw", "se", "sw")

            def flat(out):
                return {f"l{lvl}_{k}": getattr(st, k)
                        for lvl, st in enumerate(out, start=1) for k in names}

            want = flat(mg.galerkin_levels_plain(fine, shapes, True))
            errs = outputs(f"K4_{n}", flat(mg.galerkin_levels(fine, shapes, True)),
                           list(want.values()))
            timed(lambda: mg.galerkin_levels(fine, shapes, True), kernel="K4", n=n,
                  max_rel_err=max(errs.values()))
    if "K11a" in kernels:
        for (nx, ny), sweeps in AB_K11A:
            p, b, c = poisson_system(nx, ny, dev, SEED + 3)
            errs = outputs(f"K11a_{nx}x{ny}_{sweeps}",
                           {"p": k11.rbgs_sweeps(p, b, c, n_sweeps=sweeps, omega=1.5)},
                           [k11.rbgs_sweeps_plain(p, b, c, sweeps, 1.5)])
            timed(lambda: k11.rbgs_sweeps(p, b, c, n_sweeps=sweeps, omega=1.5), kernel="K11a",
                  shape=[nx, ny], sweeps=sweeps, max_rel_err=max(errs.values()))
    if "K11b" in kernels:
        for nx, ny in AB_K11B:
            p, _, c = poisson_system(nx, ny, dev, SEED + 4)
            errs = outputs(f"K11b_{nx}x{ny}", {"out": k11.apply_poisson_kernel(p, c)},
                           [k11.apply_poisson_plain(p, c)])
            timed(lambda: k11.apply_poisson_kernel(p, c), kernel="K11b", shape=[nx, ny],
                  max_rel_err=max(errs.values()))
    if "K8" in kernels or "K9" in kernels:
        from naviflow_tpu_torch.ops import assembly, cheby
        from naviflow_tpu_torch.ops.stencil import interior_mask
        from naviflow_tpu_torch.solvers.momentum import _chebyshev_bounds

        u, v, p, kw = cavity_fields(NL, dev)
        for bounds, variant in ((True, None), (False, "consistent")):
            args = dict(alpha=0.7, with_bounds=bounds, poisson_variant=variant, **kw)
            got = k8_flat(assembly.fused_assembly_pair(u, v, p, **args))
            want = k8_flat(assembly.fused_assembly_pair_plain(u, v, p, **args))
            label = "bounds" if bounds else variant
            errs = outputs(f"K8_{label}", {f"out{k}": g for k, g in enumerate(got)}, want)
            if "K8" in kernels:
                timed(lambda: assembly.fused_assembly_pair(u, v, p, **args), kernel="K8", n=NL,
                      variant=label, max_rel_err=max(errs.values()))
            if "K9" in kernels and bounds:
                for field, x0, k in (("u", u, 0), ("v", v, 2)):
                    c_un, c_rel = got_c(got, k), got_c(got, k + 1)
                    sc = _chebyshev_bounds(c_rel, interior_mask(x0.shape, 1, 1, 1, 1,
                                                                device=dev))
                    a9 = dict(theta=sc[0], delta=sc[1], sigma1=sc[2], degree=4)
                    errs9 = outputs(f"K9_{field}", dict(zip(
                        ("x", "r"), cheby.chebyshev_momentum_strips(x0, c_rel, c_un, **a9))),
                        cheby.chebyshev_momentum_strips_plain(x0, c_rel, c_un, **a9))
                    timed(lambda: cheby.chebyshev_momentum_strips(x0, c_rel, c_un, **a9),
                          kernel="K9", n=NL, field=field, max_rel_err=max(errs9.values()))
            del got, want
        del u, v, p
    if "K10a" in kernels or "K10b" in kernels:
        from naviflow_tpu_torch.ops import plane_strip

        _, pres = large_grid_configs()
        cfg = dataclasses.replace(pres, pre_smoothing=1, post_smoothing=1)
        ps, R, B, ec = plane_inputs(NP, dev, SEED + 2)
        got = plane_strip.plane_strip_down(R, B, ps, cfg)
        errs = outputs("K10a", dict(zip(("R", "B", "rc"), got)),
                       plane_strip.plane_strip_down_plain(R, B, ps, cfg))
        if "K10a" in kernels:
            timed(lambda: plane_strip.plane_strip_down(R, B, ps, cfg), kernel="K10a",
                  shape=list(R.shape), max_rel_err=max(errs.values()))
        Rs, Bs = got[:2]
        errs = outputs("K10b", dict(zip(("R", "B"), plane_strip.plane_strip_up(
            Rs, Bs, ps, ec, cfg))), plane_strip.plane_strip_up_plain(Rs, Bs, ps, ec, cfg))
        if "K10b" in kernels:
            timed(lambda: plane_strip.plane_strip_up(Rs, Bs, ps, ec, cfg), kernel="K10b",
                  shape=list(R.shape), max_rel_err=max(errs.values()))
        del ps, R, B, ec, got, Rs, Bs
    if "K6" in kernels:
        for algo, body in k6_phases(dev)["bodies"].items():
            emit(dict(phase="ab", tag=tag, kernel="K6", algo=algo,
                      rap_ms=body["phases_ms"]["rap"], sum_ms=body["sum_ms"],
                      event_ms=body["event_ms"]))
    if "loops" in kernels:
        ab_loops(dev, tag, saved, save)
    if save:
        Path(save).mkdir(parents=True, exist_ok=True)
        torch.save(saved, Path(save) / f"{tag}.pt")


def k8_flat(out):
    """K8's outputs as a flat tuple of tensors (each field's six unrelaxed
    arrays and its relaxed a_p and src, then the maxima and the fold where
    present), read from the result's own structure: the A/B's other tree
    may not have the module's helper."""
    flat = []
    for k, x in enumerate(out):
        if k in (1, 3):
            flat += [x.a_p, x.src]
        elif hasattr(x, "a_e"):
            flat += [getattr(x, f) for f in ("a_e", "a_w", "a_n", "a_s")] + [
                getattr(x, f) for f in (("a_p", "src") if hasattr(x, "src") else ("diag",))]
        else:
            flat.append(x)
    return tuple(flat)


def got_c(flat, k):
    """Coefficient set ``k`` (0 cu_un, 1 cu_rel, 2 cv_un, 3 cv_rel) of K8's
    flat outputs (``k8_flat``)."""
    from naviflow_tpu_torch.ops.stencil import StencilCoeffs

    base = 8 * (k // 2)
    un = StencilCoeffs(*flat[base:base + 6])
    return un if k % 2 == 0 else un.replace(a_p=flat[base + 6], src=flat[base + 7])


def ab_compare(save, tag_a, tag_b):
    """The saved outputs of two ``ab_side`` runs, output by output: whether
    they are bit-equal, how many elements differ and by how much at most."""
    from pathlib import Path

    import torch

    a = torch.load(Path(save) / f"{tag_a}.pt")
    b = torch.load(Path(save) / f"{tag_b}.pt")
    for case in sorted(set(a) & set(b)):
        for name, x in a[case].items():
            y = b[case][name]
            bits_x = x.contiguous().view(torch.int32)
            bits_y = y.contiguous().view(torch.int32)
            emit(dict(phase="ab_compare", a=tag_a, b=tag_b, case=case, output=name,
                      bit_equal=bool(torch.equal(bits_x, bits_y)),
                      differing=int((bits_x != bits_y).sum()),
                      max_abs_diff=float((x.double() - y.double()).abs().max()),
                      scale=float(x.double().abs().max())))


def parse_args(argv):
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of naviflow_tpu_torch on one GPU.")
    ap.add_argument("--ab", metavar="TAG", help="run one side of an A/B (ab_side) and stop")
    ap.add_argument("--kernels", default=",".join(AB_KERNELS),
                    help="the A/B's kernels, comma-separated (default: %(default)s)")
    ap.add_argument("--save", metavar="DIR",
                    help="keep the A/B's K1-K5 and K7-K11 outputs here")
    ap.add_argument("--ab-compare", nargs=3, metavar=("DIR", "TAG_A", "TAG_B"),
                    help="compare two saved A/B sides output by output and stop")
    ap.add_argument("--ranks", action="store_true",
                    help="one rank of the multi-rank NCCL run (under torchrun) and stop")
    return ap.parse_args(argv)


def main() -> int:
    args = parse_args(sys.argv[1:])
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
    if args.ranks:
        return ranks_main()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    card = nvidia_smi()
    emit(dict(phase="device", nvidia_smi=card, torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              name=torch.cuda.get_device_name(0), count=torch.cuda.device_count()))
    if args.ab_compare:
        ab_compare(*args.ab_compare)
        return 0
    if args.ab is not None:
        ab_side(dev, args.ab, tuple(args.kernels.split(",")), args.save)
        return 0

    t0 = time.perf_counter()
    _cuda.library()
    # the newton phase's CPU float64 reference runs beside the card's phases
    start_newton_reference()
    try:
        return run_all(dev, card, t0)
    finally:
        stop_newton_reference()


def run_all(dev, card, t0) -> int:
    """Every phase after the build (``main``); the exit code."""
    import torch

    from naviflow_tpu_torch.ops import _cuda, krylov, mg, step

    clusters = {algo: step.cluster_size(algo, dev) for algo in step.ALGO_SCALARS}
    # how many clusters of the batched K6 fit at once, at 16 and 8 CTAs: a
    # batch of more cases runs in waves
    k6_max_clusters = {algo: {size: step.max_active_clusters(algo, size, dev) for size in (16, 8)}
                       for algo in step.ALGO_SCALARS}
    k6_clusters = k6_max_clusters["simple"]
    k3_size, k5_size = mg.vcycle_cluster_size(dev), mg.mg_solve_cluster_size(dev)
    k4_size, k7_size = mg.galerkin_cluster_size(dev), krylov.cluster_size(dev)
    # ptxas's report of K1's, K2's, K6's (single and batched), K3's, K5's, K7's
    # and K9's kernels:
    # registers, spills, shared memory
    ptxas = {src: [line.strip() for line in _cuda.build_log.get(src, "").splitlines()
                   if "registers" in line or "spill" in line]
             for src in ("asmcheby.cu", "strip.cu", "step.cu", "step_batched.cu", "mg.cu",
                         "krylov.cu", "cheby.cu", "assembly.cu", "plane.cu")}
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds=_cuda.build_seconds, library=_cuda.library_path().name,
              k6_cluster_size=clusters,
              k6_batched_max_active_clusters={a: {str(k): c for k, c in by.items()}
                                              for a, by in k6_max_clusters.items()},
              k3_cluster_size=k3_size, k4_cluster_size=k4_size,
              k5_cluster_size=k5_size, k7_cluster_size=k7_size, cluster_threads_per_cta=512,
              k1_blocks_per_sm=blocks_per_sm("nf_asmcheby_blocks_per_sm", 4),
              **{f"{side}_blocks_per_sm": {f"{pts}pt_{sw}": blocks_per_sm(
                  f"nf_{side}_blocks_per_sm", int(pts == 5), sw)
                  for pts in (5, 9) for sw in sweeps}
                 for side, sweeps in (("strip_down", (1, 2)), ("strip_up", (0, 1, 2)))},
              ptxas=ptxas, ptxas_by_kernel={
                  **ptxas_kernels("strip.cu", "strip_up_kernel"),
                  **ptxas_kernels("strip.cu", "strip_down_kernel_batched"),
                  **ptxas_kernels("strip.cu", "strip_up_kernel_batched"),
                  **ptxas_kernels("asmcheby.cu", "asmcheby_kernel_batched"),
                  **ptxas_kernels("mg.cu", "vcycle_kernel_batched"),
                  **ptxas_kernels("cheby.cu", "cheby_kernel"),
                  **ptxas_kernels("cheby.cu", "cheby_kernel_batched"),
                  **ptxas_kernels("assembly.cu", "assembly_kernel_batched"),
                  **ptxas_kernels("plane.cu", "plane_down_kernel_batched"),
                  **ptxas_kernels("plane.cu", "plane_up_kernel_batched"),
                  **ptxas_kernels("mg.cu", "galerkin_kernel"),
                  **ptxas_kernels("krylov.cu", "bicgstab_grid_kernel"),
                  **ptxas_kernels("krylov.cu", "bicgstab_grid_kernel_batched"),
                  **ptxas_kernels("poisson.cu", "rbgs_tile_kernel"),
                  **ptxas_kernels("poisson.cu", "matvec_kernel")}))
    # one cluster barrier at each kernel's size (its bound's unit) and at 8
    cl_by_size = {size: cluster_sync_ms(size, dev)
                  for size in sorted({8, clusters["simple"], k3_size, k4_size, k5_size,
                                      k7_size})}
    cl_ms = cl_by_size[clusters["simple"]]
    emit(dict(phase="cluster_barrier", cluster_size=clusters["simple"], ms=cl_ms,
              ms_by_size={str(k): v for k, v in cl_by_size.items()}))

    sync_cache = {}

    def sync_ms(cells):
        blocks = -(-cells // 256)
        if blocks not in sync_cache:
            sync_cache[blocks] = grid_sync_ms(cells, dev)
        return sync_cache[blocks]

    t_kernel = time.perf_counter()
    rows = check_asmcheby(dev)
    levels, cfg, rng = fine_levels(dev)
    rows += check_strips(dev, levels, cfg, rng)
    row, tail = check_vcycle(dev, levels, cfg, rng, cl_by_size[k3_size])
    rows.append(row)
    del levels
    inp = odd_inputs(NH, dev, steps=5)
    big = odd_inputs(NH_BIG, dev, steps=0)
    rows += check_bicgstab([(NH, inp), (NH_BIG, big)], cl_by_size[k7_size], sync_ms)
    rows += check_rap([(NH, inp["levels"]), (NH_BIG, big["levels"])], cl_by_size[k4_size])
    pres = inp["pres"]
    even_levels, even_b = even_hierarchy(256, dev, pres)
    rows += check_mg_solve(
        [("vertex63", inp["levels"], inp["b"],
          (pres, dataclasses.replace(pres, tolerance=1e-4, max_cycles=30))),
         ("vertex255", big["levels"], big["b"], (pres,)),
         ("cell256", even_levels, even_b, (pres,))], cl_by_size[k5_size])
    del even_levels, even_b
    rows.append(check_vertex_vcycle(inp, cl_by_size[k3_size]))
    rows += check_step(dev, cl_ms)
    rows += check_step_batched(dev, cl_ms, k6_clusters[clusters["simple"]])
    rows += check_case_axis(inp, {"K7": (k7_size, cl_by_size[k7_size]),
                                  "K5": (k5_size, cl_by_size[k5_size]),
                                  "K4": (k4_size, cl_by_size[k4_size])})
    rows += check_grid_case_axis(dev, sync_ms)
    rows += check_large_case_axis(dev, cl_by_size[k3_size], k3_size)
    del big
    rows += check_step_bodies(dev, cl_ms)
    rows += check_assembly(dev)
    rows += check_cheby(dev)
    rows += check_plane(dev)
    rows += check_assembly_case_axis(dev)
    rows += check_asmcheby(dev, NP, lagged=True)  # K1 at the plane run's 4096^2 shapes
    k11_rows, k11_launches = check_poisson_kernels(dev)
    rows += k11_rows
    for row in rows:
        emit(dict(phase="kernel", **{k: v for k, v in row.items() if k != "work"},
                  bytes=row["work"][0], flops=row["work"][1]))
    emit(dict(phase="grid_barrier", ms_by_blocks={str(k): v for k, v in sync_cache.items()}))
    if not all(r["ok"] for r in rows):
        print("chip_smoke: a kernel disagrees with its plain version", file=sys.stderr)
        return 1
    emit(k6_phases(dev))
    emit(k3_phases([("tail256", *tail), ("vertex63", inp["levels"], inp["pres"], inp["b"])]))
    del tail, inp
    emit(k1_phases(dev))
    seconds = {"build": t_kernel - t0, "kernel": time.perf_counter() - t_kernel}

    paths = {"kernel_phase": k11_launches}
    for phase, fn in (("slice", run_slice), ("headline", run_headline), ("fmg", run_fmg),
                      ("large_grid", run_large_grid), ("algorithms63", run_algorithms63),
                      ("plane", run_plane), ("sequenced", run_sequenced), ("mgcg", run_mgcg),
                      ("solvers", run_solvers), ("quick", run_quick),
                      ("distributed", run_distributed), ("api", run_api),
                      ("batch", run_batch), ("batch_loops", run_batch_loops),
                      ("newton", run_newton), ("cli", run_cli)):
        t_phase = time.perf_counter()
        row = fn(dev)
        row["seconds"] = seconds[phase] = time.perf_counter() - t_phase
        emit(row)
        if not row["ok"]:
            print(f"chip_smoke: the {phase} run failed its checks", file=sys.stderr)
            return 1
        if phase == "headline":
            paths[phase] = row["runs"]["auto_0.001"]["launches"]
        elif phase == "batch":
            paths["batch"], paths["batch_fmg"] = row["launches"], row["launches_fmg"]
            paths["batch_large"] = row["launches_large"]
            paths["batch_assembly"] = row["launches_assembly"]
        elif phase == "algorithms63":
            paths.update({f"{phase}:{name}": c for name, c in row["paths"].items()})
        elif phase == "quick":
            paths["quick"], paths["quick63"] = row["launches"], row["launches_small"]
        else:
            paths[phase] = row["launches"]

    kernels = kernels_line(rows, paths)
    unlaunched = [k["name"] for k in kernels if k["launches"] < 1]
    if unlaunched:
        print(f"chip_smoke: never launched on their path (K11's path is the kernel phase, "
              f"since no path of the JAX package calls it): {unlaunched}", file=sys.stderr)
        return 1
    emit(dict(phase="seconds", seconds=seconds, total=time.perf_counter() - t0))
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
