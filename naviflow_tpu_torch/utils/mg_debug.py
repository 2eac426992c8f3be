"""Multigrid debug instrumentation: per-stage intermediate dumps to PDF
(port of ``naviflow_tpu/utils/mg_debug.py``).

Parity with the reference multigrid's debug mode (its ``multigrid.py``
debug flag stores the arrays after pre-smoothing, residual computation,
restriction, interpolation, correction and post-smoothing, and writes
them as a multi-page PDF in chronological order).

The production cycles stay untouched (on the card a whole V-cycle is one
K3 launch, or K2 strips and a K3 tail); debugging runs this separate
recorder built from the same level stencils and transfers
(``solvers/multigrid.build_levels``, ``_level_transfers``, ``_smooth``,
``apply_five``), so each recorded stage is the exact arithmetic of the
composed ``multigrid._cycle``, captured stage by stage.  matplotlib is
imported when a PDF is written.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..ops.stencil9 import apply_five
from ..postprocessing.result import to_numpy
from ..solvers.multigrid import MultigridConfig, _level_transfers, _smooth


def debug_vcycle(p, b, levels, cfg: MultigridConfig,
                 _lvl: int = 0, _stages: List | None = None
                 ) -> Tuple[torch.Tensor, List[Tuple[str, torch.Tensor]]]:
    """One V/W cycle identical to ``multigrid._cycle`` that also returns
    the chronological list of ``(stage_title, tensor)`` intermediates."""
    stages: List[Tuple[str, torch.Tensor]] = [] if _stages is None else _stages
    st, (nx, ny), five, lam = levels[_lvl]
    tag = f"L{_lvl} {nx}x{ny}"
    if _lvl == len(levels) - 1:
        p = _smooth(p, b, st, cfg, cfg.coarsest_sweeps, five, lam)
        stages.append((f"{tag}: coarsest solve ({cfg.coarsest_sweeps} sweeps)", p))
        return p, stages

    rf, pf, _ = _level_transfers(nx, ny, cfg)
    p = _smooth(p, b, st, cfg, cfg.pre_smoothing, five, lam)
    stages.append((f"{tag}: after pre-smoothing ({cfg.pre_smoothing})", p))
    r = b - apply_five(p, st, five)
    stages.append((f"{tag}: residual", r))
    rc = rf(r)
    stages.append((f"{tag}: restricted residual", rc))
    ec = torch.zeros_like(rc)
    ec, _ = debug_vcycle(ec, rc, levels, cfg, _lvl + 1, stages)
    if cfg.cycle_type == "w" and _lvl + 1 < len(levels) - 1:
        ec, _ = debug_vcycle(ec, rc, levels, cfg, _lvl + 1, stages)
    e = pf(ec)
    stages.append((f"{tag}: interpolated correction", e))
    p = p + e
    stages.append((f"{tag}: corrected solution", p))
    p = _smooth(p, b, st, cfg, cfg.post_smoothing, five, lam)
    stages.append((f"{tag}: after post-smoothing ({cfg.post_smoothing})", p))
    return p, stages


def dump_vcycle_pdf(path, p, b, levels, cfg: MultigridConfig, n_cycles=1):
    """Run ``n_cycles`` debug V-cycles and write every recorded stage as one
    PDF page (chronological), the reference's debug artifact.  Returns the
    final iterate and the number of pages written."""
    from ..postprocessing.visualization import _plt

    plt = _plt()
    from matplotlib.backends.backend_pdf import PdfPages

    n_pages = 0
    with PdfPages(path) as pdf:
        for cyc in range(n_cycles):
            p, stages = debug_vcycle(p, b, levels, cfg)
            for title, arr in stages:
                fig, ax = plt.subplots(figsize=(5, 4.2))
                im = ax.imshow(to_numpy(arr).T, origin="lower", cmap="RdBu_r", aspect="auto")
                fig.colorbar(im, ax=ax, shrink=0.85)
                ax.set_title(f"cycle {cyc + 1}: {title}", fontsize=9)
                pdf.savefig(fig)
                plt.close(fig)
                n_pages += 1
    return p, n_pages
