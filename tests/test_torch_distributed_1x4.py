"""The port's distributed SIMPLE (``parallel/dist_simple.py``) on gloo
ranks, on the CPU (f64), the part of ``tests/test_torch_distributed.py``
with spawns of its own (a file of its own so that the test workers share
the spawns):

* a padded 30^2 grid on a 1x4 mesh (Jacobi-PCG and MGCG) against the JAX
  package on a (1, 4) mesh, and its chunked loop against the per-step loop;
* the duplicated shared faces bit-equal across neighbours after 10 steps.

The rank bodies are ``tests/test_torch_distributed.py``'s (the spawned
ranks import that module, which imports JAX only inside test functions).
"""

import pytest
import torch

from test_torch_distributed import (PADDED, SHARED_FACES, _chunked_matches_per_step,
                                    _faces_body, _held_to_jax, _runs_body)
from torch_ranks import run_ranks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mesh14(tmp_path_factory):
    return run_ranks(_runs_body, (1, 4), tmp_path_factory.mktemp("mesh14"), 30, PADDED,
                     ["padded-jacobi-cg"], timeout=300)


@pytest.mark.parametrize("name", list(PADDED))
def test_padded_grid_matches_jax_1x4(name, mesh14):
    got = _held_to_jax(mesh14, name, PADDED[name], 30, (1, 4))
    assert got["u"].shape == (31, 30) and got["v"].shape == (30, 31) and got["p"].shape == (30, 30)


@pytest.mark.parametrize("fixture,name", [("mesh14", "padded-jacobi-cg")])
def test_chunked_loop_matches_per_step(fixture, name, request):
    """10 steps in chunks of 4 (the chunked loop runs on to 12, as the JAX
    package's does) against 10 single steps: the first 10 steps' residuals
    and pressure iterations identical."""
    _chunked_matches_per_step(request.getfixturevalue(fixture)[0], name)


def test_shared_faces_bit_equal_after_10_steps(tmp_path):
    """After 10 steps (power-law Jacobi + CG; QUICK BiCGSTAB + MGCG), each
    u face on a block's x edge equals its x-neighbour's copy bit for bit,
    and each v face on a y edge its y-neighbour's."""
    res = run_ranks(_faces_body, (2, 2), tmp_path, 16, 10, timeout=200)
    for name in SHARED_FACES:
        blocks = {r[name][2]: r[name][:2] for r in res}
        for by in range(2):
            assert torch.equal(blocks[(0, by)][0][-1], blocks[(1, by)][0][0]), (name, by)
        for bx in range(2):
            assert torch.equal(blocks[(bx, 0)][1][:, -1], blocks[(bx, 1)][1][:, 0]), (name, bx)
        assert float(torch.abs(blocks[(0, 0)][0][-1]).max()) > 0.0
