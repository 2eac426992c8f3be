"""Fully distributed geometric multigrid on the rank mesh (port of
``naviflow_tpu/parallel/dist_mg.py``).

The fine levels live as blocks on the 2-D rank mesh down to a
``gather_cutoff`` (~32^2 global); below it the levels are gathered once
and run replicated on every rank through the port's composed
``solvers.multigrid._cycle``.  Every piece is a distributed replica of the
single-device algorithm (``solvers/multigrid.py``), the same op sequence:

* Galerkin RAP per level by the nine-comb trick
  (``ops/stencil9.galerkin_coarsen``), comb classes on global indices,
  P / A applied block-locally with halo exchange;
* four-colour Gauss-Seidel smoothing: every neighbour of a cell has a
  different colour, so refreshing the halos before each quarter-sweep makes
  the masked block update equal to the global one;
* cell-centred transfers: the 2x2-average restriction is block-local (even
  block sizes); the bilinear prolongation reads a one-ring coarse halo with
  edge replication at physical walls (``decompose.extend_p_edge``).

No CUDA kernel runs here, as no Pallas kernel runs on the JAX package's
distributed path: the gathered tail calls the composed ``_cycle``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from ..ops.stencil9 import _OFFSET_NAMES, Stencil9, comb_select, stencil9_diagonal
from ..ops.transfer_cc import prolong_cc, restrict_cc
from ..ops.windowed import global_indices
from ..solvers.multigrid import (MultigridConfig, _cycle, _level_transfers, _smooth,
                                 levels_from_stencil)
from .decompose import Decomp, extend_p, extend_p_edge, gather_blocks, pnorm2, psum

_FIELDS = tuple(f.name for f in dataclasses.fields(Stencil9))


def _gather_stencil(st: Stencil9, rm) -> Stencil9:
    """Every array of a block stencil gathered in one all-gather."""
    g = gather_blocks(torch.stack([getattr(st, k) for k in _FIELDS]), rm)
    return Stencil9(*g.unbind(0))


# --------------------------------------------------------------------------
# block-local 9-point operator application (halo'd)
# --------------------------------------------------------------------------

def apply9_halo(x_loc, st: Stencil9, dec: Decomp, rm):
    """A @ x on a local block: one halo ring (zeros at physical edges,
    matching the zero-padded shifts of ``ops/stencil9.apply9``)."""
    x = extend_p(x_loc, dec, rm)
    return (
        st.c * x[1:-1, 1:-1]
        + st.e * x[2:, 1:-1]
        + st.w * x[:-2, 1:-1]
        + st.n * x[1:-1, 2:]
        + st.s * x[1:-1, :-2]
        + st.ne * x[2:, 2:]
        + st.nw * x[:-2, 2:]
        + st.se * x[2:, :-2]
        + st.sw * x[:-2, :-2]
    )


def _block_ij(p, dec: Decomp, rm):
    return global_indices(p.shape, rm.bx * dec.nxl, rm.by * dec.nyl, p.device)


def rb2_sweep_halo(p, b, st: Stencil9, dec: Decomp, rm, omega: float = 1.0):
    """Two-colour red-black SOR on a block == the global ``_rb2_sweep``
    (the corner entries are zero on the 5-point finest level).  Colours are
    global parity; halos refreshed before each half-sweep."""
    ii, jj = _block_ij(p, dec, rm)
    red = (ii + jj) % 2 == 0
    inv_c = 1.0 / stencil9_diagonal(st)

    def half(p, color):
        off = apply9_halo(p, st, dec, rm) - st.c * p
        p_new = (b - off) * inv_c
        return torch.where(color, p + omega * (p_new - p), p)

    p = half(p, red)
    return half(p, torch.logical_not(red))


def gs4_sweep_halo(p, b, st: Stencil9, dec: Decomp, rm, omega: float = 1.0):
    """One four-colour GS sweep on a block == the global ``gs4_sweep``:
    halos are refreshed before each quarter, and every rank updates the
    same colour at once, so every neighbour read sees the value the global
    sweep would."""
    ii, jj = _block_ij(p, dec, rm)
    inv_c = 1.0 / stencil9_diagonal(st)

    def quarter(p, color_mask):
        off = apply9_halo(p, st, dec, rm) - st.c * p
        p_new = (b - off) * inv_c
        return torch.where(color_mask, p + omega * (p_new - p), p)

    for a in range(2):
        for bpar in range(2):
            p = quarter(p, (ii % 2 == a) & (jj % 2 == bpar))
    return p


def jacobi9_sweep_halo(p, b, st: Stencil9, dec: Decomp, rm, omega: float = 0.8):
    r = b - apply9_halo(p, st, dec, rm)
    return p + omega * r / stencil9_diagonal(st)


def prolong_cc_halo(c_loc, dec_c: Decomp, rm):
    """Block-local bilinear cell-centred prolongation == the global
    ``transfer_cc.prolong_cc`` sliced per block: prolong the one-ring
    edge-replicated extension, crop the two fine ghost rows per side."""
    return prolong_cc(extend_p_edge(c_loc, dec_c, rm))[2:-2, 2:-2]


# --------------------------------------------------------------------------
# distributed Galerkin coarsening (global-index comb trick)
# --------------------------------------------------------------------------

def galerkin_coarsen_dist(st_loc: Stencil9, dec_f: Decomp, rm) -> Stencil9:
    """Exact block-local A_c = R A P (cell-centred transfers): the
    arithmetic of ``ops/stencil9.galerkin_coarsen`` with ``restrict_cc`` /
    ``prolong_cc``, comb classes and the out-of-grid mask on global coarse
    indices, each comb image computed block-locally with halo'd P -> A -> R.
    Requires even local block sizes."""
    nxc, nyc = dec_f.nx // 2, dec_f.ny // 2
    dec_c = Decomp(nx=nxc, ny=nyc, mx=dec_f.mx, my=dec_f.my)
    dtype = st_loc.c.dtype
    shape_c = (dec_c.nxl, dec_c.nyl)
    ii, jj = global_indices(shape_c, rm.bx * dec_c.nxl, rm.by * dec_c.nyl, st_loc.c.device)

    images = []
    for a in range(3):
        for b in range(3):
            comb = ((ii % 3 == a) & (jj % 3 == b)).to(dtype)
            fine = prolong_cc_halo(comb, dec_c, rm)
            images.append(restrict_cc(apply9_halo(fine, st_loc, dec_f, rm)))
    images = torch.stack(images).reshape(3, 3, *shape_c)

    entries = {}
    for (di, dj), name in _OFFSET_NAMES.items():
        val = comb_select(images, ii, jj, di, dj)
        inside = ((ii + di >= 0) & (ii + di <= nxc - 1)
                  & (jj + dj >= 0) & (jj + dj <= nyc - 1))
        entries[name] = torch.where(inside, val, torch.zeros_like(val))
    return Stencil9(**entries)


# --------------------------------------------------------------------------
# hierarchy build + cycle
# --------------------------------------------------------------------------

def n_dist_levels(dec: Decomp, gather_cutoff: int, coarsest: int) -> int:
    """How many levels (the finest included) stay distributed: coarsen
    while the next level is still above the gather cutoff AND the local
    blocks halve evenly."""
    n = 1
    nx, ny, nxl, nyl = dec.nx, dec.ny, dec.nxl, dec.nyl
    while (min(nx, ny) // 2 > gather_cutoff and nxl % 2 == 0 and nyl % 2 == 0
           and min(nx, ny) // 2 > coarsest):
        nx, ny, nxl, nyl = nx // 2, ny // 2, nxl // 2, nyl // 2
        n += 1
    return n


def build_dist_levels(
    st_fine: Stencil9, dec: Decomp, rm, cfg: MultigridConfig, gather_cutoff: int = 32,
) -> Tuple[List[Tuple[Stencil9, Decomp]], list]:
    """(distributed levels finest->coarsest, replicated tail levels).

    ``st_fine`` is the block-local fine operator.  The tail starts from the
    gathered stencil one coarsening below the last distributed level and is
    built with the single-device Galerkin recurrence, so the whole ladder
    is that of ``solvers.multigrid.build_levels`` on the global operator.
    """
    n_d = n_dist_levels(dec, gather_cutoff, cfg.coarsest_grid_size)
    dist_levels = [(st_fine, dec)]
    st, d = st_fine, dec
    for _ in range(n_d - 1):
        st = galerkin_coarsen_dist(st, d, rm)
        d = Decomp(nx=d.nx // 2, ny=d.ny // 2, mx=d.mx, my=d.my)
        dist_levels.append((st, d))

    # one more distributed coarsening gives the tail's level-0 operator,
    # gathered to every rank
    tail = []
    if min(d.nx, d.ny) > cfg.coarsest_grid_size:
        if d.nxl % 2 == 0 and d.nyl % 2 == 0:
            st_g = _gather_stencil(galerkin_coarsen_dist(st, d, rm), rm)
            tail = levels_from_stencil(st_g, d.nx // 2, d.ny // 2, cfg)
        else:
            # blocks can no longer halve: gather THIS level and coarsen
            # replicated from here (the level itself stays distributed for
            # smoothing; the tail starts one level down)
            st_g = _gather_stencil(st, rm)
            tail = levels_from_stencil(st_g, d.nx, d.ny, cfg)[1:]
    return dist_levels, tail


def _smooth_dist(p, b, st, dec, rm, cfg, n, five_point: bool):
    """The mirror of ``solvers.multigrid._smooth``: red-black SOR on the
    5-point finest level, four-colour GS on the 9-point Galerkin levels."""
    for _ in range(n):
        if cfg.smoother == "jacobi":
            p = jacobi9_sweep_halo(p, b, st, dec, rm, min(cfg.omega, 0.9))
        elif five_point:
            p = rb2_sweep_halo(p, b, st, dec, rm, cfg.omega)
        else:
            p = gs4_sweep_halo(p, b, st, dec, rm, cfg.omega)
    return p


def _block_of(ef_g, dec: Decomp, rm):
    """This rank's block of a replicated global array of ``dec``'s level."""
    i0, j0 = rm.bx * dec.nxl, rm.by * dec.nyl
    return ef_g[i0: i0 + dec.nxl, j0: j0 + dec.nyl]


def dist_cycle(p, b, dist_levels, tail_levels, lvl, cfg: MultigridConfig, rm):
    """One V/W cycle; levels ``lvl..`` distributed, then the replicated
    tail through the single-device ``_cycle``."""
    st, dec = dist_levels[lvl]
    five = lvl == 0  # the fine operator is 5-point; Galerkin levels 9-point

    if lvl == len(dist_levels) - 1 and not tail_levels:
        return _smooth_dist(p, b, st, dec, rm, cfg, cfg.coarsest_sweeps, five)

    p = _smooth_dist(p, b, st, dec, rm, cfg, cfg.pre_smoothing, five)
    r = b - apply9_halo(p, st, dec, rm)

    if lvl + 1 < len(dist_levels):
        rc = restrict_cc(r)  # block-local: deeper levels have even blocks
        ec = dist_cycle(torch.zeros_like(rc), rc, dist_levels, tail_levels, lvl + 1, cfg, rm)
        if cfg.cycle_type == "w" and not (lvl + 2 == len(dist_levels) and not tail_levels):
            ec = dist_cycle(ec, rc, dist_levels, tail_levels, lvl + 1, cfg, rm)
        corr = prolong_cc_halo(ec, dist_levels[lvl + 1][1], rm)
    else:
        # the gather boundary: restrict / prolong on the replicated global
        # arrays (the cutoff block may be odd-sized; the data is <= ~32^2)
        rc_g = restrict_cc(gather_blocks(r, rm))
        ec_g = _cycle(torch.zeros_like(rc_g), rc_g, tail_levels, 0, cfg)
        if cfg.cycle_type == "w" and len(tail_levels) > 1:
            ec_g = _cycle(ec_g, rc_g, tail_levels, 0, cfg)
        corr = _block_of(prolong_cc(ec_g), dec, rm)

    p = p + corr
    return _smooth_dist(p, b, st, dec, rm, cfg, cfg.post_smoothing, five)


def dist_fmg(b, dist_levels, tail_levels, cfg: MultigridConfig, rm):
    """Distributed full-multigrid bootstrap, the block-parallel mirror of
    ``solvers.multigrid._fmg`` on the combined ladder [distributed levels]
    + [replicated tail]: the rhs restricted down every level, the coarsest
    smoothed from zeros with ``coarsest_sweeps``, and the solution
    prolonged upward with one cycle a level."""
    rhs = [b]
    for _ in range(len(dist_levels) - 1):
        rhs.append(restrict_cc(rhs[-1]))

    if tail_levels:
        _, dec_last = dist_levels[-1]
        # tail level 0 sits one coarsening below the last distributed level
        rhs_t = [restrict_cc(gather_blocks(rhs[-1], rm))]
        for lvl in range(len(tail_levels) - 1):
            rf, _, _ = _level_transfers(*tail_levels[lvl][1], cfg)
            rhs_t.append(rf(rhs_t[-1]))
        st, _, five, lam = tail_levels[-1]
        e = _smooth(torch.zeros_like(rhs_t[-1]), rhs_t[-1], st, cfg, cfg.coarsest_sweeps,
                    five, lam)
        for lvl in range(len(tail_levels) - 2, -1, -1):
            _, pf, _ = _level_transfers(*tail_levels[lvl][1], cfg)
            e = _cycle(pf(e), rhs_t[lvl], tail_levels, lvl, cfg)
        # prolong the replicated tail solution onto the last distributed
        # level's blocks (the slice of dist_cycle's gather boundary)
        p = _block_of(prolong_cc(e), dec_last, rm)
        p = dist_cycle(p, rhs[-1], dist_levels, tail_levels, len(dist_levels) - 1, cfg, rm)
    else:
        st, dec_last = dist_levels[-1]
        p = _smooth_dist(torch.zeros_like(rhs[-1]), rhs[-1], st, dec_last, rm, cfg,
                         cfg.coarsest_sweeps, len(dist_levels) == 1)

    for lvl in range(len(dist_levels) - 2, -1, -1):
        p = prolong_cc_halo(p, dist_levels[lvl + 1][1], rm)
        p = dist_cycle(p, rhs[lvl], dist_levels, tail_levels, lvl, cfg, rm)
    return p


def dist_mg_solve(b, st_fine: Stencil9, dec: Decomp, rm, cfg: MultigridConfig, *,
                  tol: float, max_cycles: int, check_every: int = 2,
                  gather_cutoff: int = 32, real=None, n_cells=None):
    """Standalone distributed multigrid solve, the block-parallel mirror of
    ``solvers.multigrid.multigrid_solve``: an optional FMG bootstrap
    (``cfg.cycle_type='fmg'``), then cycles until the all-reduced relative
    residual drops below ``tol`` (read on the host: every rank reads the
    same value).  Returns the zero-mean solution, its residual field and
    the cycle count.

    ``real`` / ``n_cells``: padded grids -- ``dec`` is then the padded
    tiling, ``st_fine``'s padded rows are already zero, and the mean shift
    is restricted to the ``n_cells`` real cells."""
    dist_levels, tail_levels = build_dist_levels(st_fine, dec, rm, cfg,
                                                 gather_cutoff=gather_cutoff)
    bnorm = pnorm2(b, rm)
    safe_b = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    p = (dist_fmg(b, dist_levels, tail_levels, cfg, rm) if cfg.cycle_type == "fmg"
         else torch.zeros_like(b))
    cycles, rel = 0, float("inf")
    while cycles < max_cycles and rel >= tol:
        for _ in range(check_every):
            p = dist_cycle(p, b, dist_levels, tail_levels, 0, cfg, rm)
        rel = float(pnorm2(b - apply9_halo(p, st_fine, dec, rm), rm) / safe_b)
        cycles += check_every
    count = dec.nx * dec.ny if n_cells is None else n_cells
    mean = psum(torch.sum(p), rm) / count
    p = p - mean if real is None else (p - mean) * real
    return p, b - apply9_halo(p, st_fine, dec, rm), cycles


def make_dist_mg_preconditioner(st_fine: Stencil9, dec: Decomp, rm, cfg: MultigridConfig, *,
                                gather_cutoff: int = 32, n_cycles: int = 1):
    """M^{-1} r ~= ``n_cycles`` distributed multigrid cycles from a zero
    guess (the distributed counterpart of ``multigrid.precondition``)."""
    dist_levels, tail_levels = build_dist_levels(st_fine, dec, rm, cfg,
                                                 gather_cutoff=gather_cutoff)

    def apply_M(r):
        e = torch.zeros_like(r)
        for _ in range(n_cycles):
            e = dist_cycle(e, r, dist_levels, tail_levels, 0, cfg, rm)
        return e

    return apply_M
