"""The port's checkpoints and exporters (``naviflow_tpu_torch/io/``).

Checkpoints: round trips bit-equal in float32 and float64, the file read
by ``torch.load(weights_only=True)``, overwriting, the state placed on
the requested device, and ``CheckpointManager``'s keep / prune / latest and
reseeding from existing ``step_*`` directories.  Exporters: each file
against the JAX exporter's for the same seeded fields (VTK text identical,
HDF5 datasets and attributes equal, npz arrays equal).
"""

import os
import sys

import numpy as np
import pytest
import torch

from naviflow_tpu_torch.core.mesh import StructuredMesh
from naviflow_tpu_torch.core.state import FlowState
from naviflow_tpu_torch.io import exporters
from naviflow_tpu_torch.io.checkpoint import (CheckpointManager, load_checkpoint,
                                              save_checkpoint)
from naviflow_tpu_torch.postprocessing.result import SimulationResult


def _state(nx, ny, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return FlowState(u=torch.randn(nx + 1, ny, generator=g, dtype=dtype),
                     v=torch.randn(nx, ny + 1, generator=g, dtype=dtype),
                     p=torch.randn(nx, ny, generator=g, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_checkpoint_round_trip_is_bit_equal(tmp_path, dtype):
    state = _state(9, 7, dtype)
    hist = torch.linspace(1.0, 1e-6, 42, dtype=dtype)
    path = save_checkpoint(str(tmp_path / "ckpt"), state, iteration=42,
                           histories={"total": hist, "numpy": np.arange(5.0)},
                           metadata={"reynolds": 400.0, "nx": 9})
    assert os.path.isabs(path) and os.path.isdir(path)
    payload = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    assert set(payload) == {"u", "v", "p", "iteration", "histories", "metadata"}
    got, it, hists, meta = load_checkpoint(path, device="cpu")
    assert it == 42
    for k in ("u", "v", "p"):
        assert getattr(got, k).dtype == dtype
        assert torch.equal(getattr(got, k), getattr(state, k))
    assert torch.equal(hists["total"], hist)
    np.testing.assert_array_equal(hists["numpy"].numpy(), np.arange(5.0))
    assert float(meta["reynolds"]) == 400.0 and int(meta["nx"]) == 9


def test_checkpoint_overwrites_and_places_state(tmp_path):
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, _state(5, 5, torch.float64, seed=1), iteration=1)
    open(os.path.join(path, "stale.txt"), "w").close()
    new = _state(5, 5, torch.float64, seed=2)
    save_checkpoint(path, new, iteration=2)
    assert sorted(os.listdir(path)) == ["state.pt"]
    got, it, hists, meta = load_checkpoint(path, device=torch.device("cpu"))
    assert it == 2 and hists == {} and meta == {}
    assert got.device.type == "cpu" and torch.equal(got.p, new.p)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_checkpoint(path)


def test_checkpoint_manager_keeps_prunes_and_reseeds(tmp_path):
    directory = str(tmp_path / "ckpts")
    manager = CheckpointManager(directory, every=10, keep=2)
    assert manager.latest() is None
    state = _state(5, 5, torch.float32)
    assert manager.maybe_save(state, 5) is None  # not a multiple of ``every``
    for it in (10, 20, 30):
        path = manager.maybe_save(state, it, histories={"total": torch.ones(it)})
        assert path == os.path.join(directory, f"step_{it:08d}")
    assert sorted(os.listdir(directory)) == ["step_00000020", "step_00000030"]
    assert manager.latest().endswith("step_00000030")
    # a new manager (a resumed run) seeds from the existing step_* dirs
    resumed = CheckpointManager(directory, every=10, keep=2)
    assert resumed.latest().endswith("step_00000030")
    resumed.maybe_save(state, 40)
    assert sorted(os.listdir(directory)) == ["step_00000030", "step_00000040"]
    assert load_checkpoint(resumed.latest(), device="cpu")[1] == 40
    assert CheckpointManager(directory, every=0).maybe_save(state, 50) is None


def _results(tmp_path, iterations=17):
    """The same seeded fields as a port and a JAX ``SimulationResult``."""
    import naviflow_tpu as nf
    from naviflow_tpu.postprocessing.result import SimulationResult as JaxResult

    rng = np.random.default_rng(7)
    nx, ny = 12, 9
    u, v, p = rng.random((nx + 1, ny)), rng.random((nx, ny + 1)), rng.random((nx, ny))
    res = np.geomspace(1.0, 1e-5, iterations)
    port = SimulationResult(torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(p),
                            StructuredMesh(nx=nx, ny=ny), iterations=iterations,
                            residuals=torch.as_tensor(res), reynolds=400.0)
    jax = JaxResult(u, v, p, nf.StructuredMesh(nx=nx, ny=ny), iterations=iterations,
                    residuals=res, reynolds=400.0)
    return port, jax


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_vtk_text_identical_to_jax(tmp_path, dtype):
    from naviflow_tpu.io import exporters as jax_exporters

    port, jax = _results(tmp_path)
    for r in (port, jax):
        r.u, r.v, r.p = (x.astype(dtype) for x in (r.u, r.v, r.p))
    a = exporters.export_vtk(port, str(tmp_path / "sub" / "port.vtk"))
    b = jax_exporters.export_vtk(jax, str(tmp_path / "jax.vtk"))
    text = open(a).read()
    assert text == open(b).read()
    assert "DATASET STRUCTURED_POINTS\nDIMENSIONS 12 9 1\n" in text


def test_hdf5_matches_jax(tmp_path):
    import h5py

    from naviflow_tpu.io import exporters as jax_exporters

    port, jax = _results(tmp_path)
    a = exporters.export_hdf5(port, str(tmp_path / "port.h5"))
    b = jax_exporters.export_hdf5(jax, str(tmp_path / "jax.h5"))
    with h5py.File(a) as fa, h5py.File(b) as fb:
        assert sorted(fa) == sorted(fb) == ["p", "residual_history", "u", "v", "x", "y"]
        for k in fa:
            assert fa[k].dtype == fb[k].dtype
            np.testing.assert_array_equal(fa[k][()], fb[k][()])
        assert dict(fa.attrs) == dict(fb.attrs) == {"reynolds": 400.0, "iterations": 17}


def test_npz_matches_jax(tmp_path):
    from naviflow_tpu.io import exporters as jax_exporters

    port, jax = _results(tmp_path)
    a = np.load(exporters.export_npz(port, str(tmp_path / "port.npz")))
    b = np.load(jax_exporters.export_npz(jax, str(tmp_path / "jax.npz")), allow_pickle=True)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_hdf5_and_pdf_surfaces_say_what_to_install(tmp_path, monkeypatch):
    """Where h5py or matplotlib is missing (as on the card's machine), the
    surfaces that need them raise ``ImportError`` saying what to install."""
    from naviflow_tpu_torch.utils import mg_debug

    port, _ = _results(tmp_path)
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="export_hdf5 writes HDF5 and needs h5py"):
        exporters.export_hdf5(port, str(tmp_path / "out.h5"))
    with pytest.raises(ImportError, match="plotting needs matplotlib"):
        mg_debug.dump_vcycle_pdf(tmp_path / "x.pdf", None, None, [], None)
    assert not (tmp_path / "out.h5").exists()
