"""Run a function on a mesh of gloo ranks for the port's distributed tests.

:func:`run_ranks` spawns one process per rank (``torch.multiprocessing``,
the spawn method), joins them into a gloo group through a ``file://`` store
under the test's ``tmp_path``, builds each rank's
:class:`~naviflow_tpu_torch.parallel.sharding.RankMesh` and calls
``fn(rank_mesh, *args)`` there.  Each rank runs one thread.  A collective
that waits longer than ``COLLECTIVE_TIMEOUT`` raises in its rank, and the
whole group is killed when it outlives ``timeout``: a hung or crashed rank
fails the test, it never hangs the suite.  ``fn`` must be a module-level
function of a module the ranks can import (a test module), and what it
returns must pickle (tensors, numbers, dicts, lists).
"""

from __future__ import annotations

import datetime
import itertools
import os
import time
import traceback

import torch
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT = 60.0
_SPAWNS = itertools.count()


def _rank_main(rank, shape, store, out_dir, fn, args):
    import torch.distributed as dist

    from naviflow_tpu_torch.parallel.sharding import make_device_mesh

    torch.set_num_threads(1)
    out = os.path.join(out_dir, f"rank{rank}")
    try:
        dist.init_process_group("gloo", init_method=store, rank=rank,
                                world_size=shape[0] * shape[1],
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
        try:
            result = fn(make_device_mesh(shape=shape, device="cpu"), *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out + ".pt")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


class Ranks:
    """A spawned mesh of ranks (:func:`start_ranks`); :meth:`join` waits for
    it and returns ``[fn(rank_mesh, *args) for each rank]`` in rank order."""

    def __init__(self, procs, out_dir, deadline, timeout):
        self.procs, self.out_dir = procs, out_dir
        self.deadline, self.timeout = deadline, timeout

    def join(self):
        procs, out_dir, n = self.procs, self.out_dir, len(self.procs)
        for p in procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        errors = []
        for r in range(n):
            err = os.path.join(out_dir, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        if hung:
            raise TimeoutError(f"ranks {hung} still running after {self.timeout} s (killed)\n"
                               + "\n".join(errors))
        if errors or any(p.exitcode != 0 for p in procs):
            raise RuntimeError("rank failure: exit codes "
                               f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


def start_ranks(fn, shape, tmp_path, *args, timeout=120.0) -> Ranks:
    """Spawn ``fn(rank_mesh, *args)`` on an ``shape`` = (mx, my) mesh of gloo
    ranks and return at once, so that the caller can work while they run;
    ``timeout`` counts from the spawn."""
    n = shape[0] * shape[1]
    out_dir = os.path.join(str(tmp_path), f"ranks{next(_SPAWNS)}")
    os.makedirs(out_dir)
    store = "file://" + os.path.join(out_dir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, tuple(shape), store, out_dir, fn, args),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    return Ranks(procs, out_dir, time.monotonic() + timeout, timeout)


def run_ranks(fn, shape, tmp_path, *args, timeout=120.0):
    """``[fn(rank_mesh, *args) for each rank]`` on an ``shape`` = (mx, my)
    mesh of spawned gloo ranks, in rank order."""
    return start_ranks(fn, shape, tmp_path, *args, timeout=timeout).join()
