"""The multigrid pressure cases of ``tests/test_torch_distributed.py``
(``MG_CASES``: SIMPLE with Chebyshev momentum and MGCG pressure, SIMPLE
with Jacobi momentum and FMG, PISO with Jacobi momentum and MG) on a 2x2
spawn of their own, on the CPU (f64): against the JAX package's
``distributed_simple_solve`` on a (2, 2) device mesh, every step's residual
and the fields at rel 1e-10; the state the same bits on every rank; the
pressure iterations of every step equal to the same run on one rank.  And
the duplicated shared faces bit-equal across neighbours after 10 steps on a
2x2 mesh.  (A file of its own so that the test workers share the spawns;
the rank bodies are ``tests/test_torch_distributed.py``'s.)
"""

import pytest
import torch

from test_torch_distributed import (CASES, MG_CASES, SHARED_FACES, STEPS, N, _held_to_jax,
                                    _mg_body, references_while)
from torch_ranks import start_ranks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs22(tmp_path_factory):
    """The multigrid cases and 10 steps of the shared faces' runs on one 2x2
    spawn (each rank's ``runs`` and ``faces``, rank order), the JAX
    package's runs and the one-rank runs computed while the ranks run."""
    cases = {name: CASES[name] for name in MG_CASES}
    ranks = start_ranks(_mg_body, (2, 2), tmp_path_factory.mktemp("mesh22"), N, cases, 10,
                        timeout=400)
    return references_while(ranks, cases, N, (2, 2), one_rank=True)


@pytest.mark.parametrize("name", MG_CASES)
def test_distributed_matches_jax_2x2(name, runs22):
    ranks, jax_runs, one_rank = runs22
    got = _held_to_jax([r["runs"] for r in ranks], name, jax_runs[name])
    assert got["diag"]["inner_iterations"] == one_rank[name]["diag"]["inner_iterations"]
    assert len(got["diag"]["inner_iterations"]) == STEPS


def test_shared_faces_bit_equal_after_10_steps(runs22):
    """After 10 steps (power-law Jacobi + CG; QUICK BiCGSTAB + MGCG), each
    u face on a block's x edge equals its x-neighbour's copy bit for bit,
    and each v face on a y edge its y-neighbour's."""
    res = [r["faces"] for r in runs22[0]]
    for name in SHARED_FACES:
        blocks = {r[name][2]: r[name][:2] for r in res}
        for by in range(2):
            assert torch.equal(blocks[(0, by)][0][-1], blocks[(1, by)][0][0]), (name, by)
        for bx in range(2):
            assert torch.equal(blocks[(bx, 0)][1][:, -1], blocks[(bx, 1)][1][:, 0]), (name, bx)
        assert float(torch.abs(blocks[(0, 0)][0][-1]).max()) > 0.0
