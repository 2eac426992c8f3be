"""Compensated (double-single) evaluation of residuals, dots and norms (port
of ``naviflow_tpu/ops/compensated.py``).

Products use Dekker's TwoProduct (an exact split multiplication) and sums
Knuth's TwoSum; both are exact only without multiply-add contraction, which
eager PyTorch never does and the CUDA kernels turn off (``-fmad=false``).
The fold reductions are pairwise sums with a compensation channel, in the
JAX package's order: the plain versions of the K6/K7 dots and the stopping
tests of K5/K6.
"""

from __future__ import annotations

import torch


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    """Dekker split a == hi + lo (factor 2^ceil(p/2) + 1)."""
    factor = 4097.0 if a.dtype == torch.float32 else 134217729.0
    c = factor * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Dekker TwoProduct: p + e == a*b exactly (no FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def compensated_linear_combination(terms):
    """Sum of ``terms`` as a double-single (hi, lo) pair; ``terms`` are
    tensors (added as they are) or ``(coef, x)`` pairs (TwoProduct)."""
    hi = lo = None
    for t in terms:
        if isinstance(t, tuple):
            p, e = two_prod(*t)
        else:
            p, e = t, None
        if hi is None:
            hi = p
            lo = torch.zeros_like(p) if e is None else e
        else:
            hi, carry = two_sum(hi, p)
            lo = lo + carry if e is None else lo + (carry + e)
    return two_sum(hi, lo)


def _mask_overlap(b, axis, n_overlap):
    """Zero the first ``n_overlap`` rows (axis 0) or columns (axis 1)."""
    b = b.clone()
    if axis == 0:
        b[:n_overlap] = 0
    else:
        b[:, :n_overlap] = 0
    return b


def fold_sum(x, err0=None):
    """Compensated pairwise sum of all elements of a 2-D tensor: ceil-halving
    folds along axis 0, then axis 1, each a TwoSum whose errors ride in a
    side channel."""
    err = torch.zeros_like(x) if err0 is None else err0
    for axis in (0, 1):
        while x.shape[axis] > 1:
            n = x.shape[axis]
            h = (n + 1) // 2
            if axis == 0:
                a, b, ea, eb = x[:h], x[n - h:], err[:h], err[n - h:]
            else:
                a, b, ea, eb = x[:, :h], x[:, n - h:], err[:, :h], err[:, n - h:]
            if 2 * h > n:  # odd: the first row of b aliases the last of a
                b = _mask_overlap(b, axis, 2 * h - n)
                eb = _mask_overlap(eb, axis, 2 * h - n)
            x, c = two_sum(a, b)
            err = ea + eb + c
    s, _ = two_sum(x[0, 0], err[0, 0])
    return s


def fold_dot(a, b):
    """Compensated dot: exact TwoProduct per element, pairwise compensated
    accumulation."""
    p, e = two_prod(a, b)
    return fold_sum(p, err0=e)


def fold_norm2(x):
    """Compensated squared L2 norm."""
    return fold_dot(x, x)


def compensated_norm(x):
    """L2 norm with exact squaring and compensated accumulation."""
    return torch.sqrt(fold_dot(x, x))
