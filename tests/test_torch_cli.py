"""The port's command line (``naviflow_tpu_torch.cli``) against the JAX
package's (``naviflow_tpu.cli``): ``run`` summaries and saved fields, both
packages in float64 on the CPU from the same argv (the port's with
``--device cpu``).

The JAX side runs through ``_build_parser()`` / ``_run_case`` in-process
(its ``main`` would set up the compile cache), with the ``.npz`` written by
the JAX exporter as its ``main`` writes it.  Held: the same summary keys
apart from wall times; equal ``iterations`` and ``converged``;
``final_residual``, ``max_divergence`` and the Ghia errors to rel 1e-9;
the saved fields to rel 1e-10.  ``test_torch_cli_program.py`` holds the
interrupted run, ``sweep``, ``--distributed`` and the module as a program.
"""

import json

import numpy as np
import pytest

SUMMARY_REL = 1e-9
FIELD_REL = 1e-10
WALL_KEYS = {"wall_seconds", "wall_seconds_batch"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def jax_run(argv, save=None):
    """The JAX CLI's ``run`` summary for ``argv`` (and its ``.npz``)."""
    from naviflow_tpu import cli as jcli
    from naviflow_tpu.io import exporters

    args = jcli._build_parser().parse_args(argv)
    result, summary = jcli._run_case(args, args.nx, args.re)
    if save:
        exporters.export_npz(result, save)
    return summary


def port_run(argv, capsys):
    """The port CLI's ``main`` on ``argv + --device cpu``: its one JSON line."""
    from naviflow_tpu_torch import cli

    capsys.readouterr()
    assert cli.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def assert_summaries_match(got, want):
    assert set(got) - WALL_KEYS == set(want) - WALL_KEYS
    for key in set(want) - WALL_KEYS:
        if key in ("final_residual", "max_divergence", "infinity_norm_error",
                   "l2_norm_error", "newton_final_residual"):
            assert _rel(got[key], want[key]) <= SUMMARY_REL, (key, got[key], want[key])
        else:
            assert got[key] == want[key], (key, got[key], want[key])


def assert_npz_match(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    for k in ("u", "v", "p"):
        assert got[k].dtype == np.float64
        assert _rel(got[k], want[k]) <= FIELD_REL, k
    for k in ("x", "y", "reynolds", "iterations"):
        np.testing.assert_array_equal(got[k], want[k])
    assert _rel(got["residuals"], want["residuals"]) <= SUMMARY_REL


# algorithm, pressure, momentum, grid: the four algorithms, the pressure
# solvers rbgs / cg / direct / multigrid / mgcg, the momentum solvers
# jacobi / rbgs / bicgstab, both grid parities
CASES = [
    ("simple", "rbgs", "jacobi", 15),
    ("simplec", "cg", "rbgs", 16),
    ("piso", "direct", "bicgstab", 15),
    ("simpler", "multigrid", "jacobi", 16),
    ("simple", "mgcg", "rbgs", 15),
]


def _argv(algorithm, pressure, momentum, nx, *extra):
    return ["run", "--nx", str(nx), "--re", "100", "--algorithm", algorithm,
            "--pressure", pressure, "--momentum", momentum, "--tolerance", "1e-3",
            "--max-iterations", "400", "--f64", *extra]


@pytest.mark.parametrize("algorithm,pressure,momentum,nx", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_run_summary_and_fields_match_jax(tmp_path, capsys, algorithm, pressure, momentum, nx):
    argv = _argv(algorithm, pressure, momentum, nx)
    want = jax_run(argv, save=str(tmp_path / "jax.npz"))
    got = port_run(argv + ["--save", str(tmp_path / "port.npz")], capsys)
    assert want["converged"] and want["iterations"] > 3
    assert_summaries_match(got, want)
    assert_npz_match(tmp_path / "port.npz", tmp_path / "jax.npz")


@pytest.mark.parametrize("extra", [("--scheme", "quick"), ("--sequence",)],
                         ids=["quick", "sequence"])
def test_run_quick_and_sequence_match_jax(tmp_path, capsys, extra):
    argv = _argv("simple", "rbgs", "bicgstab", 16, *extra)
    want = jax_run(argv, save=str(tmp_path / "jax.npz"))
    got = port_run(argv + ["--save", str(tmp_path / "port.npz")], capsys)
    assert want["converged"]
    assert_summaries_match(got, want)
    assert_npz_match(tmp_path / "port.npz", tmp_path / "jax.npz")
