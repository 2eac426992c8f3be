"""Gates of the JAX package's kernels that this port has not rewritten yet.

Each rule below is its JAX counterpart's, with "the backend is a TPU"
replaced by "the tensor is on a CUDA device".  The port uses them only to
refuse: where the JAX package would launch one of these kernels, the port
raises :class:`NotImplementedError` naming the kernel and its ROADMAP line,
instead of dropping to the composed path silently.  ``backend='composed'``
in the config is the one way around them.

The window caps are TPU VMEM budgets.  They are kept as they are so that
the port splits the work exactly as the reference does; retuning them for
the H100 is a later measurement's job.
"""

from __future__ import annotations

import torch

from . import _cuda

# ops/pallas_assembly.py: folded-window cap and halo rows
_ASM_PAD = 16
_ASM_CAP_FOLDED = 280 * 1024
# ops/pallas_cheby.py: halo rows and window cap
_CHEBY_H = 16
_CHEBY_CAP = 384 * 1024


def not_ported(kernel: str, roadmap: str):
    """The error every refused kernel gate raises."""
    return NotImplementedError(
        f"{kernel} has no CUDA port yet (ROADMAP {roadmap}); the JAX package "
        "would launch it here. Pass backend='composed' in the config to run "
        "the composed PyTorch path instead.")


def supports_fused_assembly(nx, ny, scheme, dtype, backend, device) -> bool:
    """K8 gate (``ops/pallas_assembly.py:supports_fused_assembly``)."""
    if backend not in ("auto", "kernel") or not _cuda.kernel_device(device):
        return False
    if scheme != "power_law" or dtype != torch.float32:
        return False
    if nx < 384 or ny < 256:
        return False
    return any(nx % T == 0 and (T + 2 * _ASM_PAD) * ny <= _ASM_CAP_FOLDED
               for T in (128, 64, 32, 16))


def supports_cheby_strips(shape, dtype, device) -> bool:
    """K9 gate (``ops/pallas_cheby.py:supports_cheby_strips``)."""
    if dtype != torch.float32 or not _cuda.kernel_device(device):
        return False
    ni, nj = shape
    if ni < 1536 or nj < 1536:
        return False
    lane_nj = -(-nj // 128) * 128
    return any((T + 2 * _CHEBY_H) * lane_nj <= _CHEBY_CAP and ni - 1 > T
               for T in (256, 128, 64, 32))
