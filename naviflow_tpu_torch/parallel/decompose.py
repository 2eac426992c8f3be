"""Explicit staggered domain decomposition over a 2-D mesh of ranks (port
of ``naviflow_tpu/parallel/decompose.py``).

The global staggered fields are decomposed into per-rank blocks, every
stencil op runs on the local block, halos travel by
``torch.distributed.batch_isend_irecv`` and reductions (residual norms,
Krylov dot products) are all-reduces.

Block layout (rank (bx, by) of an (mx, my) :class:`~.sharding.RankMesh`;
global p grid (nx, ny); nxl = ceil(nx / mx), nyl = ceil(ny / my)):

* cells gi0..gi0+nxl-1 x gj0..gj0+nyl-1, gi0 = bx*nxl, gj0 = by*nyl;
* u faces gi0..gi0+nxl (the faces on block edges are duplicated between
  x-neighbours and kept consistent by construction: both owners compute
  them from identical halo data);
* v faces gj0..gj0+nyl (duplicated between y-neighbours).

The blocked global arrays stack the local blocks: ``U_blk``
(mx*(nxl+1), my*nyl), ``V_blk`` (mx*nxl, my*(nyl+1)), ``P_blk`` (nx, ny);
:func:`block` cuts a rank's block out of one.

Every collective bumps one of :data:`COLLECTIVES`' counters: ``p2p`` (one
``batch_isend_irecv`` along one mesh axis), ``all_reduce`` and
``all_gather``.  The exchanges along x come before those along y on every
rank, and every rank calls each collective in the same order.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..ops.stencil import StencilCoeffs, pad2

# collective calls by kind, read by chip_smoke.py
COLLECTIVES = {"p2p": 0, "all_reduce": 0, "all_gather": 0}


def reset_collectives():
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


# --------------------------------------------------------------------------
# blocked layout conversions (global tensors)
# --------------------------------------------------------------------------

def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pad_axis(a, axis: int, size: int):
    """Zero-pad ``a`` up to ``size`` along ``axis`` (no-op when equal)."""
    if a.shape[axis] == size:
        return a
    if axis == 0:
        return pad2(a, 0, size - a.shape[0])
    return pad2(a, 0, 0, 0, size - a.shape[1])


def to_blocked_u(u, mx: int, my: int = 1):
    """(nx+1, ny) -> (mx*(nxl+1), my*nyl): per-block face rows with
    duplicated shared edges.  Non-divisible grids are zero-padded up to the
    tiled extent (``nxl = ceil(nx/mx)``); the padded cells are excluded from
    every update and reduction by the global-index masks (the real ``nx``
    is carried on :class:`Decomp`)."""
    nx = u.shape[0] - 1
    nxl, nyl = _ceil_div(nx, mx), _ceil_div(u.shape[1], my)
    u = _pad_axis(_pad_axis(u, 0, mx * nxl + 1), 1, my * nyl)
    return torch.cat([u[b * nxl: b * nxl + nxl + 1, :] for b in range(mx)], 0)


def from_blocked_u(u_blk, mx: int):
    """Inverse of :func:`to_blocked_u` up to the zero padding (crop the
    result to ``[:nx+1, :ny]`` for non-divisible grids)."""
    nrow = u_blk.shape[0] // mx
    parts = [u_blk[b * nrow: (b + 1) * nrow, :] for b in range(mx)]
    return torch.cat([p[:-1] for p in parts[:-1]] + [parts[-1]], 0)


def to_blocked_v(v, my: int, mx: int = 1):
    ny = v.shape[1] - 1
    nxl, nyl = _ceil_div(v.shape[0], mx), _ceil_div(ny, my)
    v = _pad_axis(_pad_axis(v, 0, mx * nxl), 1, my * nyl + 1)
    return torch.cat([v[:, b * nyl: b * nyl + nyl + 1] for b in range(my)], 1)


def from_blocked_v(v_blk, my: int):
    ncol = v_blk.shape[1] // my
    parts = [v_blk[:, b * ncol: (b + 1) * ncol] for b in range(my)]
    return torch.cat([p[:, :-1] for p in parts[:-1]] + [parts[-1]], 1)


def to_blocked_p(p, mx: int, my: int):
    """(nx, ny) zero-padded to the (mx, my)-tiled extent (identity for
    divisible grids)."""
    nxl, nyl = _ceil_div(p.shape[0], mx), _ceil_div(p.shape[1], my)
    return _pad_axis(_pad_axis(p, 0, mx * nxl), 1, my * nyl)


def block(x_blk, rm):
    """Rank ``rm``'s block of a blocked global array (a copy)."""
    mx, my = rm.shape
    a, b = x_blk.shape[0] // mx, x_blk.shape[1] // my
    return x_blk[rm.bx * a: (rm.bx + 1) * a, rm.by * b: (rm.by + 1) * b].clone()


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def _halo(a, axis: int, rm, n_shards: int, lo_send: int, hi_send: int, width: int = 1):
    """Return (halo_lo, halo_hi): ``width``-wide slices received from the
    lower / upper neighbour along mesh ``axis`` (zeros at physical edges).

    ``lo_send``: start index of MY slice that the upper neighbour uses as
    its lo halo; ``hi_send``: start index of my slice the lower neighbour
    uses as its hi halo.  One ``batch_isend_irecv`` a call.
    """
    def take(idx):
        return a.narrow(axis, idx % a.shape[axis], width).contiguous()

    shape = list(a.shape)
    shape[axis] = width
    lo, hi = a.new_zeros(shape), a.new_zeros(shape)
    if n_shards == 1:
        return lo, hi
    coord = rm.bx if axis == 0 else rm.by
    ops = []
    if coord + 1 < n_shards:
        up = rm.peer(axis, 1)
        ops.append(dist.P2POp(dist.isend, take(lo_send), up, rm.group))
        ops.append(dist.P2POp(dist.irecv, hi, up, rm.group))
    if coord > 0:
        down = rm.peer(axis, -1)
        ops.append(dist.P2POp(dist.isend, take(hi_send), down, rm.group))
        ops.append(dist.P2POp(dist.irecv, lo, down, rm.group))
    COLLECTIVES["p2p"] += 1
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return lo, hi


def psum(x, rm):
    """The sum of ``x`` (a tensor of partial sums, any shape) over every
    rank: one all-reduce, the same bits on every rank."""
    COLLECTIVES["all_reduce"] += 1
    if rm.group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, group=rm.group)
    return x


def pmax(x, rm):
    """The elementwise maximum of ``x`` over every rank (exact)."""
    COLLECTIVES["all_reduce"] += 1
    if rm.group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=rm.group)
    return x


def gather_blocks(x_loc, rm):
    """Local (..., a, b) block -> the full global (..., mx*a, my*b) array
    on every rank (one all-gather), assembled in mesh order."""
    COLLECTIVES["all_gather"] += 1
    if rm.group is None:
        return x_loc
    x_loc = x_loc.contiguous()
    parts = [torch.empty_like(x_loc) for _ in range(rm.size)]
    dist.all_gather(parts, x_loc, group=rm.group)
    mx, my = rm.shape
    rows = [torch.cat(parts[bx * my: (bx + 1) * my], -1) for bx in range(mx)]
    return torch.cat(rows, -2)


@dataclasses.dataclass(frozen=True)
class Decomp:
    """Static decomposition descriptor.

    ``nx``/``ny`` are the REAL global cell counts; ``nxl``/``nyl`` the
    per-block extents (``ceil``): for non-divisible grids the blocked
    layout is zero-padded up to ``(nxp, nyp) = (mx*nxl, my*nyl)`` and every
    update and reduction masks on global indices against the real sizes,
    so padded cells stay exactly zero and contribute nothing."""

    nx: int
    ny: int
    mx: int
    my: int

    @property
    def nxl(self):
        return _ceil_div(self.nx, self.mx)

    @property
    def nyl(self):
        return _ceil_div(self.ny, self.my)

    @property
    def nxp(self):
        """Padded (tiled) global x extent."""
        return self.mx * self.nxl

    @property
    def nyp(self):
        return self.my * self.nyl

    @property
    def padded(self):
        return self.nxp != self.nx or self.nyp != self.ny


def _extend(x, dec: Decomp, rm, x_sends, y_sends, width: int = 1):
    """Halo-extend along x, then along y on the x-extended block (corners
    ride two hops).  Along an axis of one rank the halos are zeros: one
    pad, no exchange."""
    if dec.mx == 1:
        x = pad2(x, width, width)
    else:
        lo, hi = _halo(x, 0, rm, dec.mx, *x_sends, width=width)
        x = torch.cat([lo, x, hi], 0)
    if dec.my == 1:
        return pad2(x, 0, 0, width, width)
    lo, hi = _halo(x, 1, rm, dec.my, *y_sends, width=width)
    return torch.cat([lo, x, hi], 1)


def extend_u(u_loc, dec: Decomp, rm):
    """(nxl+1, nyl) -> (nxl+3, nyl+2) with neighbour halos (zeros at edges).
    x halos: the neighbour's second face from the shared edge (the shared
    face itself is duplicated locally); y halos: neighbour cell columns."""
    return _extend(u_loc, dec, rm, (-2, 1), (-1, 0))


def extend_v(v_loc, dec: Decomp, rm):
    """(nxl, nyl+1) -> (nxl+2, nyl+3)."""
    return _extend(v_loc, dec, rm, (-1, 0), (-2, 1))


def extend_p(p_loc, dec: Decomp, rm):
    """(nxl, nyl) -> (nxl+2, nyl+2)."""
    return _extend(p_loc, dec, rm, (-1, 0), (-1, 0))


def extend_u2(u_loc, dec: Decomp, rm):
    """(nxl+1, nyl) -> (nxl+5, nyl+4): TWO halo rings (zeros at physical
    edges) for the 9-point QUICK / LUDS momentum stencils."""
    return _extend(u_loc, dec, rm, (-3, 1), (-2, 0), width=2)


def extend_v2(v_loc, dec: Decomp, rm):
    """(nxl, nyl+1) -> (nxl+4, nyl+5)."""
    return _extend(v_loc, dec, rm, (-2, 0), (-3, 1), width=2)


def extend_p2(p_loc, dec: Decomp, rm):
    """(nxl, nyl) -> (nxl+4, nyl+4): two halo rings."""
    return _extend(p_loc, dec, rm, (-2, 0), (-2, 0), width=2)


def extend_p_edge(p_loc, dec: Decomp, rm):
    """(nxl, nyl) -> (nxl+2, nyl+2) with edge-replicated physical
    boundaries (interior halos from the neighbours as usual): the halo the
    cell-centred bilinear prolongation needs, since ``prolong_cc`` clamps
    at the domain's edges."""
    lo, hi = _halo(p_loc, 0, rm, dec.mx, -1, 0)
    if rm.bx == 0:
        lo = p_loc[:1]
    if rm.bx == dec.mx - 1:
        hi = p_loc[-1:]
    p = torch.cat([lo, p_loc, hi], 0)
    lo, hi = _halo(p, 1, rm, dec.my, -1, 0)
    if rm.by == 0:
        lo = p[:, :1]
    if rm.by == dec.my - 1:
        hi = p[:, -1:]
    return torch.cat([lo, p, hi], 1)


# --------------------------------------------------------------------------
# distributed reductions / stencil helpers
# --------------------------------------------------------------------------

def pnorm2(x, rm):
    """Global L2 norm of a (possibly masked) local field."""
    return torch.sqrt(psum(torch.sum(x * x), rm))


def pmean(x, count, rm):
    return psum(torch.sum(x), rm) / count


def apply_stencil_halo(x_loc, c: StencilCoeffs, extend_fn, dec: Decomp, rm):
    """A @ x on a local block: extend with halos, apply, crop."""
    x_ext = extend_fn(x_loc, dec, rm)
    return (
        c.a_p * x_loc
        - c.a_e * x_ext[2:, 1:-1]
        - c.a_w * x_ext[:-2, 1:-1]
        - c.a_n * x_ext[1:-1, 2:]
        - c.a_s * x_ext[1:-1, :-2]
    )


def neighbor_sum_halo(x_loc, c: StencilCoeffs, extend_fn, dec: Decomp, rm):
    x_ext = extend_fn(x_loc, dec, rm)
    return (
        c.a_e * x_ext[2:, 1:-1]
        + c.a_w * x_ext[:-2, 1:-1]
        + c.a_n * x_ext[1:-1, 2:]
        + c.a_s * x_ext[1:-1, :-2]
    )
