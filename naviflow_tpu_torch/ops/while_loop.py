"""The port's ``lax.while_loop`` and its batching rule.

``while_loop(cond, body, *operands)`` runs ``operands = body(*operands)``
while ``cond(*operands)`` holds and returns the operands.  Every operand is
a tensor (counts are int32 tensors, flags bool ones) and ``body`` returns
as many, of the same shapes and dtypes; ``cond`` returns a 0-d bool tensor.
Every tensor that ``cond`` and ``body`` read is an operand: the closures
capture only numbers and configurations (:func:`flatten` turns a tree of
tensors, such as a multigrid hierarchy, into operands and back).

* Outside ``torch.func.vmap``: ``while bool(cond(*ops)): ops = body(*ops)``,
  one host read an iteration.
* Under ``torch.func.vmap`` alone: a ``torch.autograd.Function`` whose
  ``vmap`` rule is ``jax.vmap(lax.while_loop)``'s: every operand with its
  case axis first; ``going = active & vmap(cond)(*ops)``, where ``active``
  is the enclosing :func:`~naviflow_tpu_torch.ops._cuda.case_mask`'s flags
  (the lockstep loop's frozen cases); the loop stops when no case is going
  (one host read an iteration for every case); else ``vmap(body)`` runs
  inside ``case_mask(going)``, so that a kernel of the body leaves at once
  for a case that has stopped, and each stopped case keeps its operands
  (``torch.where``).  Each case thus stops at its own iteration count, with
  its single call's operands wherever the batched operators round as the
  single ones do.
* Under any other transform (``jvp``, forward-mode AD, a ``make_fx``
  trace) it raises: the loop reads the host, and the primitive has no
  derivative rule.

``HOST_READS`` counts the loop tests read on the host.

:func:`case_by_case` is a loop's reduction to a number (a dot, a norm, a
mean) or small dense solve: outside ``torch.func.vmap`` the call itself, under it the call on
each case's operands one case after another.
A batched ``torch.dot``, ``torch.linalg.vector_norm`` or ``torch.mean``
sums in another order than the single call on the card, and a Krylov loop
can amplify that (BiCGSTAB pressure at 128^2: fields 1.2e-3 apart after
3 steps); case by case, each case's numbers are its single solve's.
"""

from __future__ import annotations

import copy

import torch

from . import _cuda

HOST_READS = 0


def while_loop(cond, body, *operands):
    """``lax.while_loop`` over a tuple of tensor operands (see the module
    docstring); returns the final operands as a tuple."""
    global HOST_READS
    if _cuda.under_vmap():
        return _WhileCases.apply(cond, body, *operands)
    if _cuda.under_transform():
        raise RuntimeError(
            "while_loop: a loop that reads the host cannot run under torch.func or "
            "forward-mode AD, except torch.func.vmap alone")
    ops = tuple(operands)
    while True:
        HOST_READS += 1
        if not bool(cond(*ops)):
            return ops
        ops = tuple(body(*ops))


def case_by_case(fn, *xs):
    """``fn(*xs)``, with ``fn`` a reduction of whole fields or a small dense
    solve; inside ``torch.func.vmap`` (the innermost transform), ``fn`` on
    each case's operands (shared ones as they are) one case after another,
    stacked, so that each case rounds as its single call (see the module
    docstring; the cases of an enclosing vmap batch as usual).  Each case's
    operand is handed over contiguous and 16-byte aligned, as a single
    call's field is."""
    func = torch._C._functorch
    interpreter = func.peek_interpreter_stack()
    if interpreter is None or interpreter.key() != func.TransformType.Vmap:
        return fn(*xs)
    level, cases = interpreter.level(), []
    for x in xs:
        if func.is_batchedtensor(x) and func.maybe_get_level(x) == level:
            cases.append([_aligned(c) for c in
                          func.get_unwrapped(x).unbind(func.maybe_get_bdim(x))])
        else:
            cases.append(None)
    n = next((len(c) for c in cases if c is not None), 0)
    if not n:  # every operand shared
        return fn(*xs)
    out = torch.stack([fn(*(x if c is None else c[k] for x, c in zip(xs, cases)))
                       for k in range(n)])
    return func._add_batch_dim(out, 0, level)


def _aligned(x):
    """One case's operand as a single call finds a field: contiguous and
    16-byte aligned (a vectorised reduction's order depends on both)."""
    if torch._C._functorch.is_functorch_wrapped_tensor(x):  # an enclosing transform's
        return x
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _same(new, old) -> bool:
    """``new`` is ``old``'s storage as it was (an operand the body handed
    back unchanged)."""
    return (new is old or (new.data_ptr() == old.data_ptr() and new.shape == old.shape
                           and new.stride() == old.stride() and new.dtype == old.dtype))


class _WhileCases(torch.autograd.Function):
    """The batching rule of :func:`while_loop` (see the module docstring).
    It has no derivative: ``setup_context`` does nothing, and ``jvp`` raises
    for want of a rule."""

    generate_vmap_rule = False

    @staticmethod
    def forward(cond, body, *operands):
        return while_loop(cond, body, *operands)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, cond, body, *operands):
        global HOST_READS
        cases = info.batch_size
        ops = [_cuda.case_first(x, d, cases) for x, d in zip(operands, in_dims[2:])]
        outer = _cuda.active_cases(cases)
        vcond, vbody = torch.func.vmap(cond), torch.func.vmap(body)
        while True:
            going = vcond(*ops)
            if outer is not None:
                going = going & outer
            HOST_READS += 1
            if not bool(going.any()):
                break
            with _cuda.case_mask(going):
                new = vbody(*ops)
            ops = [o if _same(n, o) else
                   torch.where(going.view(-1, *(1,) * (n.dim() - 1)), n, o)
                   for n, o in zip(new, ops)]
        return tuple(ops), (0,) * len(ops)


def flatten(tree):
    """The tensors of a tree (tuples, lists, and dataclasses or other
    objects whose attributes hold tensors; numbers, strings and None are
    static) and a function that rebuilds it from a list of them (a copy of
    each object with its tensor attributes replaced)."""
    if torch.is_tensor(tree):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, (tuple, list)):
        parts = [flatten(x) for x in tree]
        sizes = [len(leaves) for leaves, _ in parts]

        def build(xs):
            out, k = [], 0
            for (_, fn), n in zip(parts, sizes):
                out.append(fn(xs[k:k + n]))
                k += n
            return type(tree)(out)

        return [x for leaves, _ in parts for x in leaves], build
    if hasattr(tree, "__dict__") and not callable(tree):
        names = sorted(vars(tree))
        leaves, build = flatten(tuple(vars(tree)[k] for k in names))
        if not leaves:
            return [], lambda xs: tree

        def rebuild(xs):
            out = copy.copy(tree)
            out.__dict__.update(zip(names, build(xs)))
            return out

        return leaves, rebuild
    return [], lambda xs: tree
