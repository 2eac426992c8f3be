"""The port's distributed SIMPLE (``parallel/dist_simple.py``) on gloo
ranks, on the CPU (f64), the part of ``tests/test_torch_distributed.py``
with spawns of its own (a file of its own so that the test workers share
the spawns):

* a padded 30^2 grid on a 1x4 mesh (Jacobi-PCG and MGCG) against the JAX
  package on a (1, 4) mesh, and its chunked loop against the per-step loop
  (the duplicated shared faces after 10 steps on a 2x2 mesh:
  ``tests/test_torch_distributed_mg.py``).

The rank bodies are ``tests/test_torch_distributed.py``'s (the spawned
ranks import that module, which imports JAX only inside test functions).
"""

import pytest
import torch

from test_torch_distributed import (PADDED, _chunked_matches_per_step, _held_to_jax, _runs_body,
                                    references_while)
from torch_ranks import start_ranks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs14(tmp_path_factory):
    """The padded cases on one 1x4 spawn, the JAX package's runs computed
    while the ranks run."""
    ranks = start_ranks(_runs_body, (1, 4), tmp_path_factory.mktemp("mesh14"), 30, PADDED,
                        ["padded-jacobi-cg"], timeout=300)
    return references_while(ranks, PADDED, 30, (1, 4))


@pytest.fixture(scope="module")
def mesh14(runs14):
    """The ranks' results, rank order."""
    return runs14[0]


@pytest.mark.parametrize("name", list(PADDED))
def test_padded_grid_matches_jax_1x4(name, runs14):
    got = _held_to_jax(runs14[0], name, runs14[1][name])
    assert got["u"].shape == (31, 30) and got["v"].shape == (30, 31) and got["p"].shape == (30, 30)


@pytest.mark.parametrize("fixture,name", [("mesh14", "padded-jacobi-cg")])
def test_chunked_loop_matches_per_step(fixture, name, request):
    """10 steps in chunks of 4 (the chunked loop runs on to 12, as the JAX
    package's does) against 10 single steps: the first 10 steps' residuals
    and pressure iterations identical."""
    _chunked_matches_per_step(request.getfixturevalue(fixture)[0], name)
