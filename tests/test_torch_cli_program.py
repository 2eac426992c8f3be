"""The port's command line against the JAX package's, continued: the
interrupted run (``--checkpoint-dir`` then ``--resume``), ``sweep`` with
and without ``--vmap``, ``--distributed`` on four gloo ranks, and the
module run as a program (``python -m naviflow_tpu_torch.cli``), with and
without a card to run on.

Both packages run in float64 on the CPU from the same argv (the port's
with ``--device cpu``).  Checkpoint fields are held to rel 1e-10, sweep
residuals to rel 1e-9, iterations and the kept ``step_*`` names exactly.
This module imports JAX only inside its tests: the spawned ranks import
it.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import torch

from torch_ranks import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELD_REL = 1e-10
SUMMARY_REL = 1e-9


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _steps(directory):
    return sorted(d for d in os.listdir(directory) if d.startswith("step_"))


def test_checkpoint_and_resume_match_jax(tmp_path, capsys):
    """30 iterations in chunks of 10 with checkpoints, then a resume to 60:
    the same kept checkpoints as the JAX CLI's, each with the same
    iteration, fields and residual history."""
    from naviflow_tpu import cli as jcli
    from naviflow_tpu.io.checkpoint import load_checkpoint as jax_load

    from naviflow_tpu_torch import cli
    from naviflow_tpu_torch.io.checkpoint import load_checkpoint

    def argv(directory, iterations, *extra):
        return ["run", "--nx", "15", "--pressure", "rbgs", "--momentum", "jacobi",
                "--tolerance", "1e-12", "--max-iterations", str(iterations),
                "--loop", "chunked:10", "--f64", "--checkpoint-dir", str(directory), *extra]

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for iterations, extra, kept in ((30, (), ["step_00000020", "step_00000030"]),
                                    (60, ("--resume",), ["step_00000050", "step_00000060"])):
        jargs = jcli._build_parser().parse_args(argv(jdir, iterations, *extra))
        _, want = jcli._run_case(jargs, jargs.nx, jargs.re)
        assert cli.main(argv(tdir, iterations, *extra) + ["--device", "cpu"]) == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert got["iterations"] == want["iterations"] == iterations - (30 if extra else 0)
        assert _rel(got["final_residual"], want["final_residual"]) <= SUMMARY_REL
        assert _steps(tdir) == _steps(jdir) == kept
        for name in kept:
            state, it, hist, meta = load_checkpoint(str(tdir / name), device="cpu")
            jstate, jit, jhist, _ = jax_load(str(jdir / name))
            assert it == jit == int(name[5:])
            assert meta == {}
            for k in ("u", "v", "p"):
                assert getattr(state, k).dtype == torch.float64
                assert _rel(getattr(state, k), np.asarray(getattr(jstate, k))) <= FIELD_REL
            assert hist["total"].shape == np.asarray(jhist["total"]).shape
            assert _rel(hist["total"], np.asarray(jhist["total"])) <= SUMMARY_REL


def test_sweep_matches_jax_batched(tmp_path, capsys):
    """``sweep`` over two Reynolds numbers, case by case and with
    ``--vmap``: the same rows (apart from wall times) either way, each with
    the JAX ``_run_batched`` row's iterations and residual."""
    from naviflow_tpu import cli as jcli

    from naviflow_tpu_torch import cli

    argv = ["sweep", "--nx", "15", "--re", "100", "400", "--pressure", "rbgs",
            "--momentum", "jacobi", "--tolerance", "1e-3", "--max-iterations", "400", "--f64"]
    jargs = jcli._build_parser().parse_args(argv)
    want = jcli._run_batched(jargs, 15, jargs.re)
    capsys.readouterr()
    rows = {}
    for tag, extra in (("each", ()), ("vmap", ("--vmap",))):
        out = tmp_path / tag
        assert cli.main(argv + list(extra) + ["--device", "cpu", "--out", str(out)]) == 0
        printed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
        with open(out / "sweep_summary.json") as f:
            rows[tag] = json.load(f)
        assert printed == rows[tag]
    wall = {"wall_seconds", "wall_seconds_batch", "batched"}
    for a, b in zip(rows["each"], rows["vmap"]):
        assert {k: v for k, v in a.items() if k not in wall} == \
            {k: v for k, v in b.items() if k not in wall}
    assert [r["reynolds"] for r in rows["vmap"]] == [100.0, 400.0]
    for got, w in zip(rows["vmap"], want):
        assert set(got) == set(w)
        assert got["iterations"] == w["iterations"] and got["converged"] == w["converged"]
        assert _rel(got["final_residual"], w["final_residual"]) <= SUMMARY_REL
    assert rows["vmap"][0]["iterations"] != rows["vmap"][1]["iterations"]


def _cli_rank(rm, argv, npz):
    """One gloo rank: the CLI's ``--distributed`` run (stdout captured),
    then a direct ``distributed_simple_solve`` with the CLI's mapped config."""
    import naviflow_tpu_torch as nt
    from naviflow_tpu_torch import cli
    from naviflow_tpu_torch.parallel.dist_simple import distributed_simple_solve

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv + ["--save", npz])
    args = cli._build_parser().parse_args(argv)
    mesh = nt.StructuredMesh(nx=args.nx, ny=args.nx)
    fluid = nt.FluidProperties(density=1.0, reynolds_number=args.re)
    bc = nt.lid_driven_cavity(1.0)
    state = nt.initialize_state(mesh, bc, dtype=torch.float64, device="cpu")
    final, diag = distributed_simple_solve(mesh, fluid, bc, state, rm,
                                           cli._distributed_config(args))
    return dict(rc=rc, stdout=out.getvalue(), u=final.u, v=final.v, p=final.p,
                iterations=diag["iterations"], final_residual=diag["final_residual"])


def test_distributed_on_four_ranks_matches_direct_solve(tmp_path):
    """``run --distributed`` on a 2x2 mesh of gloo ranks: rank 0 alone
    prints (one JSON line, the JAX summary's keys, ``device_mesh`` as
    ``dict(mesh.shape)``) and writes the solution, which equals the direct
    ``distributed_simple_solve`` with the CLI's mapped configuration."""
    argv = ["run", "--distributed", "--nx", "16", "--re", "100", "--pressure", "multigrid",
            "--momentum", "jacobi", "--max-iterations", "20", "--tolerance", "1e-3",
            "--f64", "--device", "cpu"]
    npz = str(tmp_path / "dist.npz")
    out = run_ranks(_cli_rank, (2, 2), tmp_path, argv, npz, timeout=150.0)
    assert [r["rc"] for r in out] == [0, 0, 0, 0]
    assert [r["stdout"] for r in out[1:]] == ["", "", ""]
    lines = out[0]["stdout"].strip().splitlines()
    assert len(lines) == 1
    summary = json.loads(lines[0])
    assert set(summary) == {"nx", "reynolds", "algorithm", "distributed", "device_mesh",
                            "pressure", "momentum", "scheme", "iterations", "converged",
                            "final_residual", "wall_seconds", "infinity_norm_error"}
    assert summary["device_mesh"] == {"x": 2, "y": 2}
    assert (summary["pressure"], summary["momentum"]) == ("mg", "jacobi")
    assert summary["iterations"] == out[0]["iterations"]
    assert summary["final_residual"] == out[0]["final_residual"]
    saved = np.load(npz)
    for r in out:
        for k in ("u", "v", "p"):
            np.testing.assert_array_equal(saved[k], r[k].numpy())


def _module_run(args, env=None):
    return subprocess.run([sys.executable, "-m", "naviflow_tpu_torch.cli", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO, **(env or {})))


def test_module_runs_as_a_program(tmp_path):
    vtk = tmp_path / "out.vtk"
    res = _module_run(["run", "--nx", "15", "--pressure", "rbgs", "--momentum", "jacobi",
                       "--tolerance", "1e-3", "--device", "cpu", "--save", str(vtk)])
    assert res.returncode == 0, res.stderr[-2000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["converged"] is True and summary["nx"] == 15
    assert vtk.read_text().startswith("# vtk DataFile Version 3.0\n")


def test_no_card_exits_nonzero():
    """Without ``--device cpu`` the CLI asks for the card; with none
    visible it exits non-zero with the device error, never running on the
    CPU quietly."""
    res = _module_run(["run", "--nx", "15", "--tolerance", "1e-3"],
                      env={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "no CUDA device is available; pass --device cpu" in res.stderr
    assert res.stdout.strip() == ""
