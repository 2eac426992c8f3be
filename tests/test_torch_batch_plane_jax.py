"""The vmapped batch of ``algorithms/batch.py`` in the colour-plane fine
layout (its even arm through K10a / K10b, K8 and K9) against the JAX
package's ``batched_cavity_solve`` on the CPU (float64).

(b) With the kernel gates forced open and scaled down
(``torch_batch_gates.assembly_gates_open``: a 64^2 grid takes the 4096^2
plane path below K1's gate), SIMPLE with the large-grid configuration in
the plane layout to rel 1e-9 of the JAX package's one ``jax.vmap`` program
(its plane levels composed), with one batched K10a, K10b, K8, K3 and strip
pair and two batched K9 calls a lockstep step and every single plain call
inside them.
"""

import torch
from torch_batch_gates import (MOM, PLANE, against_jax, assembly_gates_open,  # noqa: F401
                               gates_open)

torch.set_num_threads(2)


def test_plane_batch_matches_jax_vmap_program(assembly_gates_open):
    """SIMPLE in the plane layout at 64^2, Re 100 / 400 / 1000, 10 fixed
    lockstep steps, float64."""
    against_jax(assembly_gates_open, "simple", MOM, PLANE,
                {"K8": 1, "K9": 2, "K10a": 1, "K10b": 1, "K2a": 1, "K2b": 1, "K3": 1})
