"""The port's outer-loop modes against the JAX package's on the CPU
(float64) at 31^2, the odd (vertex) grid: ``'fused'``, ``'host'`` and
``'chunked:K'`` with and without the lagged coarse rebuild (32^2 and the
rest: ``test_torch_loops_sequencing.py``)."""

import pytest
import torch
from torch_loops import LOOPS, check_loop_mode

torch.set_num_threads(2)


@pytest.mark.parametrize("n,loop,rebuild", [(31, loop, rebuild) for loop in LOOPS
                                            for rebuild in (1, 8)])
def test_loop_modes_match_jax(n, loop, rebuild):
    """Each loop mode at 31^2 against the JAX package's
    (``torch_loops.check_loop_mode``)."""
    check_loop_mode(n, loop, rebuild)
