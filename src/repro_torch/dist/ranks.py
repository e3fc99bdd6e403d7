"""Start the ranks of a `torch.distributed` program, one process each.

JAX drives every device from one controller; `torch.distributed` runs one
process per rank, so the SPMD solvers (`make_spmd_solver`,
`make_async_spmd_solver`) need a launcher. `run_ranks` is it: it spawns
``world_size`` processes, joins them into one process group and returns
what each rank's function returned.

The function runs in a fresh interpreter (the ``spawn`` start method), so
it must be a module-level function of an importable module, and its
arguments and result must pickle. Tensors in the arguments travel through
shared memory; the result travels as pickled bytes, so it may hold CPU
tensors (move CUDA ones to the CPU first).
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_ranks"]

# Seconds a rank that has exited may stay unreported before it counts as
# lost: its result can still be in the queue's pipe when it exits.
_EXIT_GRACE = 2.0


def _rank_main(rank: int, world_size: int, backend: str, init_method: str,
               device: str, timeout: float, fn: Callable, args: tuple,
               results) -> None:
    """One rank: join the group, run ``fn(*args)``, report to the parent."""
    torch.set_num_threads(1)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except Exception:               # the parent raises it, naming the rank
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable[..., Any], world_size: int, *,
              args: tuple = (), backend: str = "gloo",
              device: str | Sequence[str] = "cpu",
              timeout: float = 120.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` ranks and return the results in
    rank order.

    Each rank is a spawned process with one CPU thread, on ``device``
    (one for all ranks, or one per rank; a CUDA device becomes the rank's
    current device). The ranks meet through a ``file://`` store in a fresh
    temporary directory, so launches running side by side never share a
    port, and join the default process group of ``backend`` with
    ``timeout`` on its collectives.

    When a rank raises, dies, or the ranks have not all reported within
    ``timeout`` seconds, every rank is killed and the call raises,
    naming the rank: a hung collective fails the caller instead of
    stalling it.
    """
    devices = ([str(device)] * world_size
               if isinstance(device, (str, torch.device))
               else [str(d) for d in device])
    if len(devices) != world_size:
        raise ValueError(f"run_ranks got {len(devices)} devices for "
                         f"{world_size} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(r, world_size, backend, init_method, devices[r], timeout, fn,
              args, results)) for r in range(world_size)]
    done: dict[int, Any] = {}
    exited: dict[int, float] = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(done) < world_size:
            try:
                rank, ok, payload = results.get(timeout=0.1)
            except queue.Empty:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if r in done or p.exitcode is None:
                        continue
                    if now - exited.setdefault(r, now) > _EXIT_GRACE:
                        raise RuntimeError(
                            f"rank {r} of {world_size} exited with code "
                            f"{p.exitcode} without a result")
                if now > deadline:
                    missing = [r for r in range(world_size) if r not in done]
                    raise TimeoutError(
                        f"rank {missing[0]} of {world_size} (ranks "
                        f"{missing} in all) did not finish within "
                        f"{timeout:g} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{payload}")
            done[rank] = pickle.loads(payload)
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()) + _EXIT_GRACE)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(_EXIT_GRACE)
        results.close()
        results.join_thread()
        shutil.rmtree(tmp, ignore_errors=True)
    return [done[r] for r in range(world_size)]
