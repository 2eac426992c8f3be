"""K3: one whole multigrid V-cycle over a level hierarchy, in one launch.

Replaces ``naviflow_tpu/ops/pallas_mg.py:fused_vcycle``; the CUDA kernel
is ``csrc/mg.cu`` (a cooperative launch with grid-wide barriers between
passes; its header says what bounds it on the H100).  The plain version is
the composed ``solvers/multigrid._cycle(p, b, levels, 0, cfg)``.

:func:`supports_fused` is the reference's admission rule for the fused
tail; on the large-grid path it picks the first level of the tail
(256^2 at a 1024^2 grid).
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

# The TPU kernel's whole-hierarchy VMEM budget.  It keeps the port's
# peel/tail split identical to the reference's; it is not an H100 limit.
VMEM_BUDGET_BYTES = 8 * 2**20

_MAX_LEVELS = 16  # csrc/mg.cu MAX_LEVELS

LAUNCHES = 0


def _padded_bytes(nx, ny):
    """f32 footprint of an (nx, ny) array under the TPU's (8, 128) tiling."""
    return (-(-nx // 8) * 8) * (-(-ny // 128) * 128) * 4


def supports_fused(levels, cfg) -> bool:
    """True when the (levels, cfg) combination is one the fused V-cycle
    takes (the reference's rule; see module docstring)."""
    if (cfg.cycle_type not in ("v", "fmg") or cfg.smoother != "gs"
            or cfg.restriction != "full_weighting"
            or cfg.prolongation != "linear"
            or getattr(cfg, "smoother_dtype", "float32") != "float32"):
        return False
    total = 0
    for st, (nx, ny), five, _ in levels:
        if nx != ny or st.c.dtype != torch.float32:
            return False
        total += ((5 if five else 9) + 3) * _padded_bytes(nx, ny)
    for (_, (nf, _), _, _), (_, (nc, _), _, _) in zip(levels, levels[1:]):
        if nf not in (2 * nc, 2 * nc + 1):
            return False
    return total <= VMEM_BUDGET_BYTES


def fused_vcycle_plain(p, b, levels, cfg):
    from ..solvers.multigrid import _cycle

    return _cycle(p, b, levels, 0, cfg)


def fused_vcycle(p, b, levels, cfg):
    """One V-cycle at level 0 of ``levels`` (drop-in for
    ``multigrid._cycle(p, b, levels, 0, cfg)``), as one kernel launch."""
    global LAUNCHES
    if not p.is_cuda:
        return fused_vcycle_plain(p, b, levels, cfg)
    if cfg.cycle_type not in ("v", "fmg") or cfg.smoother != "gs":
        raise ValueError("fused_vcycle implements Gauss-Seidel V-cycles only")
    if len(levels) > _MAX_LEVELS:
        raise ValueError(f"fused_vcycle takes at most {_MAX_LEVELS} levels")
    for (_, (nf, mf), _, _), (_, (nc, mc), _, _) in zip(levels, levels[1:]):
        if (nf, mf) != (2 * nc, 2 * mc):
            raise ValueError("fused_vcycle implements cell-centred (even) "
                             f"hierarchies only, got {(nf, mf)} -> {(nc, mc)}")
    out = p.clone()  # level 0's iterate, updated in place by the kernel
    _cuda.require(b, out.shape, "b")
    keep = [out]  # every buffer must outlive the launch call
    ptrs = []
    ip = [len(levels), cfg.pre_smoothing, cfg.post_smoothing, cfg.coarsest_sweeps]
    for lvl, (st, (ni, nj), five, _) in enumerate(levels):
        arrays = [st.c, st.e, st.w, st.n, st.s]
        if not five:
            arrays += [st.ne, st.nw, st.se, st.sw]
        for k, a in enumerate(arrays):
            _cuda.require(a, (ni, nj), f"level {lvl} stencil[{k}]")
        if lvl == 0:
            x, rhs = out, b
        else:
            x = torch.empty((ni, nj), dtype=torch.float32, device=p.device)
            rhs = torch.empty_like(x)
            keep += [x, rhs]
        ptrs += [a.data_ptr() for a in arrays] + [0] * (9 - len(arrays))
        ptrs += [x.data_ptr(), rhs.data_ptr()]
        ip += [ni, nj, int(five)]
    c_ptrs = (ctypes.c_longlong * len(ptrs))(*ptrs)
    c_ip = (ctypes.c_int * len(ip))(*ip)
    c_fp = (ctypes.c_float * 1)(cfg.omega)
    _cuda.check(_cuda.library().nf_fused_vcycle(c_ptrs, c_ip, c_fp, _cuda.stream_of(p)),
                "fused_vcycle")
    LAUNCHES += 1
    return out
