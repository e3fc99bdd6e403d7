"""Rank programs of the SPMD solvers, for `repro_torch.dist.ranks.run_ranks`.

`solve_cases` runs a list of cases on the calling rank and returns, for
each, what a caller holds the solvers to: the outputs (on the CPU), the
kernel dispatches and launches the case made on this rank, the θ bytes
this rank received from other ranks, and the wall time. The tests, the
dispatch pass and ``chip_smoke.py`` hand it to `run_ranks`; it lives
here because a spawned rank imports the module of its function.

A case is a dict with ``"solver"``:

* ``"sync"`` / ``"async"``: ``make_spmd_solver`` /
  ``make_async_spmd_solver`` with ``mode`` and ``backend``, then
  ``run(packed, num_iters, **kw)`` (``kw`` optional; a case's own
  ``packed`` replaces the shared one). A ValueError from the solver is
  returned as ``{"error": message}``.
* ``"mask"``: `activation_mask(seed, r, num_nodes, **kw)` for r in
  ``range(rounds)``, stacked.
* ``"split"``: one round taken apart on this rank: ``num_iters``
  exchanges of θ alone, the same number of rounds on the local table
  alone (``backend``), and the kernel wrapper's host-side index check
  alone, each timed to the end of its device work (seconds per call).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.async_gossip import activation_mask
from repro_torch.dist.async_gossip import make_async_spmd_solver
from repro_torch.dist.dekrr_spmd import (PackedProblem, _make_exchange,
                                         _NodeRound, _rank_device,
                                         exchange_counts, make_spmd_solver,
                                         reset_exchange_counts)
from repro_torch.kernels import ops
from repro_torch.obs.dispatch import dispatch_count
from repro_torch.obs.metrics import perf_clock

__all__ = ["solve_cases"]


def _cpu(value):
    """Outputs with every tensor moved to the CPU (NamedTuples kept)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, tuple):
        items = [_cpu(v) for v in value]
        return type(value)(*items) if hasattr(value, "_fields") \
            else tuple(items)
    return value


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _split(packed: PackedProblem, case: dict, device: torch.device) -> dict:
    rounds = int(case["num_iters"])
    step = _NodeRound(packed, None, device, case["backend"])
    exchange = _make_exchange(case["mode"], None, packed.offsets, step.slots)
    theta = torch.zeros_like(step.node.d)
    nbr = exchange(theta)
    node = step.node
    table = torch.cat([theta, nbr])

    def timed(fn) -> float:
        dist.barrier()
        _sync(device)
        t0 = perf_clock()
        for _ in range(rounds):
            fn()
        _sync(device)
        return (perf_clock() - t0) / rounds

    return {
        "exchange_s": timed(lambda: exchange(theta)),
        "round_s": timed(lambda: step(theta, nbr)),
        "index_check_s": timed(lambda: ops._check_dekrr_indices(
            table.shape[0], node.nbr_idx, step.self_idx, node.nbr_mask)),
    }


def _run_case(packed: PackedProblem, case: dict, device) -> dict:
    kind = case["solver"]
    packed = case.get("packed", packed)
    if kind == "mask":
        return {"out": torch.stack([
            activation_mask(case["seed"], r, case["num_nodes"],
                            **case.get("kw", {}))
            for r in range(case["rounds"])])}
    device = _rank_device(device)
    if kind == "split":
        return _split(packed, case, device)
    make = make_spmd_solver if kind == "sync" else make_async_spmd_solver
    try:
        run = make(mode=case["mode"], backend=case["backend"], device=device)
        reset_exchange_counts()
        launches = ops.launch_counts()
        dist.barrier()
        t0 = perf_clock()
        box = []
        dispatches, _ = dispatch_count(
            lambda: box.append(run(packed, case["num_iters"],
                                   **case.get("kw", {}))))
        _sync(device)
        seconds = perf_clock() - t0
    except ValueError as exc:
        return {"error": str(exc)}
    after = ops.launch_counts()
    return {"out": _cpu(box[0]), "dispatches": dispatches,
            "launches": {k: after[k] - launches[k] for k in after},
            "wire_bytes": exchange_counts()["bytes"],
            "exchanges": exchange_counts()["exchanges"],
            "seconds": seconds}


def solve_cases(packed: PackedProblem, cases: list[dict],
                device=None) -> list[dict]:
    """Run ``cases`` in order on this rank (see the module doc); the
    solvers run on ``device`` (the rank's current card by default)."""
    return [_run_case(packed, case, device) for case in cases]
