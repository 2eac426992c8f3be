"""The port's field wrappers, placeholders and example drivers.

``ScalarField`` / ``VectorField`` against the JAX package's for every
boundary (and the top boundary's ``reflect``), exactly; the two
placeholders; each example's ``run(args)`` on the CPU at <= 16^2 with
loose tolerances (what each reports: finite fields, a falling or
converged residual, the operator checks passing); ``profile_analysis``
on a profile the port's profiler wrote through an example's ``main``.
"""

import importlib

import numpy as np
import pytest
import torch

import naviflow_tpu_torch as nt
from naviflow_tpu_torch.examples._common import parse

BOUNDARIES = ("left", "right", "bottom", "top")


def _jax_mesh(nx, ny):
    import naviflow_tpu as nf

    return nf.StructuredMesh(nx=nx, ny=ny)


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_scalar_field_matches_jax(boundary):
    import naviflow_tpu as nf

    port = nt.ScalarField(nt.StructuredMesh(nx=6, ny=5), initial_value=0.25,
                          dtype=torch.float64, device="cpu")
    jax = nf.ScalarField(_jax_mesh(6, 5), initial_value=0.25, dtype=np.float64)
    assert port.set_boundary_value(boundary, 2.5) is port
    jax.set_boundary_value(boundary, 2.5)
    assert port.data.device.type == "cpu" and port.data.shape == (6, 5)
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(jax.data))


@pytest.mark.parametrize("boundary,reflect", [(b, False) for b in BOUNDARIES] + [("top", True)])
def test_vector_field_matches_jax(boundary, reflect):
    import jax.numpy as jnp

    import naviflow_tpu as nf

    port = nt.VectorField(nt.StructuredMesh(nx=6, ny=5), dtype=torch.float64, device="cpu")
    jax = nf.VectorField(_jax_mesh(6, 5), dtype=jnp.float64)
    # a non-zero interior so the reflection has something to mirror
    rng = np.random.default_rng(1)
    u0, v0 = rng.random((7, 5)), rng.random((6, 6))
    port.u, port.v = torch.as_tensor(u0), torch.as_tensor(v0)
    jax.u, jax.v = jnp.asarray(u0), jnp.asarray(v0)
    assert port.set_boundary_value(boundary, 1.5, -0.5, reflect=reflect) is port
    jax.set_boundary_value(boundary, 1.5, -0.5, reflect=reflect)
    np.testing.assert_array_equal(port.u.numpy(), np.asarray(jax.u))
    np.testing.assert_array_equal(port.v.numpy(), np.asarray(jax.v))


def test_field_wrappers_refuse_unknown_boundary_and_missing_card():
    mesh = nt.StructuredMesh(nx=4, ny=4)
    with pytest.raises(ValueError, match="Unknown boundary: front"):
        nt.ScalarField(mesh, device="cpu").set_boundary_value("front", 1.0)
    with pytest.raises(ValueError, match="Unknown boundary: front"):
        nt.VectorField(mesh, device="cpu").set_boundary_value("front")
    assert nt.ScalarField(mesh, device="cpu").data.dtype == torch.float32
    if not torch.cuda.is_available():
        for make in (lambda: nt.ScalarField(mesh), lambda: nt.VectorField(mesh)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


def test_placeholders():
    from naviflow_tpu_torch.core.unstructured import UnstructuredMesh
    from naviflow_tpu_torch.postprocessing import cylinder_flow

    with pytest.raises(NotImplementedError, match="use StructuredMesh"):
        UnstructuredMesh(nodes=[])
    assert "placeholder" in cylinder_flow.__doc__


def _finite(result):
    return all(np.isfinite(getattr(result, k)).all() for k in ("u", "v", "p"))


# name, argv (always with --device cpu), extra parse flags, check of run(args)
EXAMPLES = {
    "cavity_basic": (["--nx", "15", "--tolerance", "1e-3"], {}, lambda r: r.converged),
    "cavity_bicgstab": (["--nx", "15", "--re", "100", "--tolerance", "1e-3"], {},
                        lambda r: r.converged and len(r.get_history("infinity_norm_error")) == 1),
    "cavity_gauss_seidel": (["--nx", "11", "--max-iterations", "5"], {},
                            lambda r: r.iterations == 5 and r.residuals[-1] < r.residuals[0]),
    "cavity_jacobi": (["--nx", "11"], {}, lambda r: r.converged and r.profiler.iterations > 0),
    "cavity_mgcg": (["--nx", "15", "--re", "100", "--tolerance", "1e-3"], {},
                    lambda r: r.converged),
    "cavity_multigrid": (["--nx", "15", "--tolerance", "1e-3"], dict(cycle="v"),
                         lambda r: r.converged),
    "cavity_piso": (["--nx", "15", "--tolerance", "1e-3"], {}, lambda r: r.converged),
    "cavity_quick": (["--nx", "7", "--max-iterations", "1"], {},
                     lambda r: sorted(r) == ["power_law", "quick"]
                     and not np.array_equal(r["quick"].u, r["power_law"].u)),
    # SIMPLE stops short of the tolerance, one Newton step reaches it
    "cavity_newton": (["--nx", "7", "--max-iterations", "5", "--tolerance", "1.5e-3"],
                      dict(scheme="quick"),
                      lambda r: not bool(r["diag"].converged) and r["newton"].converged
                      and r["newton"].iterations == 1),
    "distributed_cavity": (["--nx", "16", "--tolerance", "1e-3"], {},
                           lambda r: bool(r["diag"]["converged"])
                           and r["mesh_shape"] == {"x": 1, "y": 1}),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_run(name):
    argv, extra, check = EXAMPLES[name]
    mod = importlib.import_module(f"naviflow_tpu_torch.examples.{name}")
    out = mod.run(parse(argv=argv + ["--device", "cpu"], **extra))
    if isinstance(out, dict) and "state" in out:
        assert all(torch.isfinite(getattr(out["state"], k)).all() for k in ("u", "v", "p"))
    elif not isinstance(out, dict):
        assert _finite(out)
    assert check(out)


def test_example_cavity_sequenced():
    from naviflow_tpu_torch.examples import cavity_sequenced

    out = cavity_sequenced.run(cavity_sequenced.parse(
        ["--nx", "16", "--re", "100", "--tolerance", "1e-3", "--coarsest", "8",
         "--device", "cpu"]))
    assert [s["nx"] for s in out["levels"]] == [8, 16]
    assert all(s["converged"] for s in out["levels"]) and bool(out["diag"].converged)


def test_example_operator_sanity():
    from naviflow_tpu_torch.examples import operator_sanity

    rows = operator_sanity.run(operator_sanity.parse(["--device", "cpu"]))
    assert [r["variant"] for r in rows] == ["reference", "symmetric", "consistent"]
    assert all(r["ok"] for r in rows)
    assert rows[0]["symmetry_defect"] > 1e-3
    assert rows[1]["symmetry_defect"] < 1e-12 and rows[2]["symmetry_defect"] < 1e-12


def test_profile_analysis_reads_the_port_profile(tmp_path, capsys):
    """``cavity_multigrid``'s ``main`` writes its profile and plots; the
    analysis reads the profile back and plots it."""
    from naviflow_tpu_torch.examples import cavity_multigrid, profile_analysis

    cavity_multigrid.main(["--nx", "15", "--tolerance", "1e-3", "--device", "cpu",
                           "--outdir", str(tmp_path)])
    profile = tmp_path / "SIMPLE_Re100_mesh15x15_profile.h5"
    assert profile.exists()
    assert (tmp_path / "multigrid_15_Re100_combined.png").exists()
    iterations = int(capsys.readouterr().out.split("iters=")[1].split()[0])
    rows = profile_analysis.run(profile_analysis.parse([str(profile)]))
    assert len(rows) == 1
    row = rows[0]
    assert (row["algorithm"], row["nx"], row["reynolds"]) == ("SIMPLE", 15, 100.0)
    assert row["iterations"] == iterations == row["residuals"].size
    assert row["converged"] and row["inner"].size == iterations
    assert "SIMPLE_Re100_mesh15x15_profile.h5" in capsys.readouterr().out
    profile_analysis.main([str(profile), "--plot", str(tmp_path / "profiles.png")])
    assert (tmp_path / "profiles.png").stat().st_size > 1000
