"""The vmapped SIMPLEC batch of ``algorithms/batch.py`` (its even arm
through K8 and K9) against the JAX package's ``batched_cavity_solve`` on the
CPU (float64).

(b) With the kernel gates forced open and scaled down
(``torch_batch_gates.assembly_gates_open``: a 64^2 grid takes the 2048^2
path), the batch to rel 1e-9 of the JAX package's one ``jax.vmap``
program, with one batched K8, two batched K9, two batched K2a, two batched
K2b and one batched K3 call a lockstep step and every single plain call
inside them.  (The JAX package's K8 closes over ``mu``, so on a TPU its
SIMPLEC batch would not trace with a per-case viscosity; on the CPU its
step is composed, which the port's plain kernels compose alike.)
"""

import torch
from torch_batch_gates import (MOM, PRES, against_jax, assembly_gates_open,  # noqa: F401
                               gates_open)

torch.set_num_threads(2)


def test_simplec_batch_matches_jax_vmap_program(assembly_gates_open):
    """SIMPLEC at 64^2, Re 100 / 400 / 1000, 10 fixed lockstep steps (the
    alpha_p backoff a per-case decision in both), float64."""
    against_jax(assembly_gates_open, "simplec", MOM, PRES,
                {"K8": 1, "K9": 2, "K2a": 2, "K2b": 2, "K3": 1})
