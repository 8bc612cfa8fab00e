"""Run a function on several ranks of this host (the tests' and
``chip_smoke.py``'s launcher; a training run starts its ranks with
``torchrun`` and ``--multihost`` instead).

``run_ranks(fn, world, ...)`` spawns ``world`` processes (start method
``spawn``: each imports ``fn``'s module afresh, so ``fn`` must sit in a
module that imports no JAX), joins them in one process group initialised
from a file (no TCP port), activates the mesh and calls ``fn(mesh, *args)``.
A child's exception is raised again in the parent
(``torch.multiprocessing.ProcessRaisedException``): the first rank's to
fail, so that a rank ended in a collective by another's failure does not
hide the cause, whichever exit the parent sees first.  A child that dies
raises ``ProcessExitedException``, and a collective that waits past
``timeout_s`` fails its rank.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_ranks(fn, world: int, args=(), backend: str = "gloo", device=None,
              timeout_s: float = 300.0, init_dir=None, threads: int | None = None) -> None:
    """``fn(mesh, *args)`` on ranks 0..world-1, each on ``device``
    (``mesh.make_mesh``'s rule: the caller's, else ``cuda:LOCAL_RANK``,
    here the rank); ``threads`` sets each child's torch threads."""
    with tempfile.TemporaryDirectory(dir=init_dir) as tmp:
        init_file = os.path.join(tmp, "init")
        try:
            mp.start_processes(_rank_main, args=(fn, world, backend, f"file://{init_file}",
                                                 timeout_s, device, threads, tuple(args), tmp),
                               nprocs=world, join=True, start_method="spawn")
        except mp.ProcessRaisedException as e:
            first = _first_failure(tmp, world)
            if first is None or first[0] == e.error_index:
                raise
            rank, pid, trace = first
            raise mp.ProcessRaisedException(
                f"\n\n-- Process {rank} terminated first, with the following error:\n{trace}",
                rank, pid) from e


def _first_failure(tmp, world):
    """(rank, pid, traceback) of the rank whose ``fn`` failed first, from
    the records ``_rank_main`` writes, or None."""
    found = []
    for rank in range(world):
        path = os.path.join(tmp, f"failed{rank}")
        if os.path.exists(path):
            when, pid, trace = open(path).read().split("\n", 2)
            found.append((float(when), rank, int(pid), trace))
    return min(found)[1:] if found else None


def _rank_main(rank, fn, world, backend, init_method, timeout_s, device, threads, args,
               fail_dir):
    from ..utils.device import rank_device
    from .mesh import make_mesh
    from .sharding import activate

    if threads is not None:
        torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    dev = rank_device(device)  # a rank without a card raises here
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = make_mesh(device=dev)
        activate(mesh)
        fn(mesh, *args)
    except BaseException:
        # when, for the parent: a rank whose collective a failed rank ended
        # fails later than that rank
        with open(os.path.join(fail_dir, f"failed{rank}"), "w") as f:
            f.write(f"{time.time()!r}\n{os.getpid()}\n{traceback.format_exc()}")
        raise
    finally:
        activate(None)
        dist.destroy_process_group()
