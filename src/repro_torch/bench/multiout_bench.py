"""Multi-output DeKRR: the fused Dy-output solve against a loop of
per-output scalar solves, the counterpart of
`benchmarks/multiout_bench.py`.

    python -m repro_torch.bench.multiout_bench [--fast] [--out PATH] \
        [--device cpu]

The Eq. 17 auxiliaries do not depend on the labels, so a Dy-output
problem can be solved as Dy scalar solves; that loop is the baseline.
The fused path packs labels and θ as [J, D_max, Dy] and runs ONE solve
whose kernels carry Dy as extra rows of the θ table, so the G/S/P
traffic ((2 + K)·D² per node and round, the dominant term) is paid once
instead of Dy times, at the same dispatch count.

Per backend and Dy: fused_us / loop_us (median of ``reps`` runs, host
clock up to a device synchronize), and the kernel dispatches of each,
counted from one run (`repro_torch.obs.dispatch.dispatch_count`, where
the reference counts the traced program's `pallas_call`s): the fused
solve keeps the scalar contract {torch: 0, cuda: R, cuda_fused: 1} at
every Dy, the loop pays Dy× it. Each row asserts fused == loop at rtol
1e-9. The data: J circulant(1, 2) nodes of random cos_bias maps (a
seeded `torch.Generator`, or the caller's ``fmaps``) and numpy-seeded
inputs and labels, as the reference draws them.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.bench.common import cli, device_name, median_us, write_json
from repro_torch.core import (DeKRRConfig, DeKRRSolver, NodeData, circulant,
                              sample_rff)
from repro_torch.dist import pack_problem, solve_batched
from repro_torch.obs.dispatch import dispatch_count, round_dispatches
from repro_torch.paper import common as C

BACKENDS = ("torch", "cuda", "cuda_fused")


def build_packs(dy: int, j_nodes: int, d_feat: int, n_per_node: int, *,
                fmaps=None, device=None):
    """(the fused Dy-output pack, the Dy per-output scalar packs) on the
    same data: inputs and labels from ``np.random.default_rng(0)``, maps
    ``fmaps`` or `sample_rff` from a `torch.Generator` seeded with j."""
    topo = circulant(j_nodes, (1, 2))
    rng = np.random.default_rng(0)
    if fmaps is None:
        fmaps = [sample_rff(torch.Generator().manual_seed(j), 4, d_feat,
                            C.SIGMA) for j in range(j_nodes)]
    fmaps = [fm.to(device) for fm in fmaps]
    xs = [rng.normal(size=(4, n_per_node)) for _ in range(j_nodes)]
    ys = [rng.normal(size=(n_per_node, dy)) for _ in range(j_nodes)]

    def pack(col):
        data = [NodeData(x=torch.as_tensor(x, device=device),
                         y=torch.as_tensor(y if col is None else y[:, col],
                                           device=device))
                for x, y in zip(xs, ys)]
        solver = DeKRRSolver(topo, fmaps, data,
                             DeKRRConfig(lam=0.1, c_nei=1.0),
                             build_aux=False, device=device)
        return pack_problem(solver, device=device)

    return pack(None), [pack(o) for o in range(dy)]


def multiout_row(fused_pk, scalar_pks, rounds: int, *, device,
                 reps: int) -> dict:
    """One Dy: per backend the fused and looped θ (asserted equal at rtol
    1e-9), their times and their dispatches, the fused count held to
    `round_dispatches` and the loop's to Dy times it."""
    dy = len(scalar_pks)
    row = {"dy": dy, "backends": {}}
    for b in BACKENDS:
        out = {}

        def fused(b=b):
            out["fused"] = solve_batched(fused_pk, rounds, backend=b)

        def loop(b=b):
            out["loop"] = torch.stack(
                [solve_batched(pk, rounds, backend=b) for pk in scalar_pks],
                dim=2)

        n_fused, _ = dispatch_count(fused)
        n_loop, _ = dispatch_count(loop)
        want = round_dispatches(b, rounds)
        if (n_fused, n_loop) != (want, dy * want):
            raise RuntimeError(
                f"multiout dy={dy} backend={b}: {n_fused} fused and "
                f"{n_loop} looped dispatches; the contract is {want} and "
                f"{dy * want}")
        np.testing.assert_allclose(out["fused"].cpu().numpy(),
                                   out["loop"].cpu().numpy(),
                                   rtol=1e-9, atol=1e-12)
        fused_us = median_us(fused, reps, device)
        loop_us = median_us(loop, reps, device)
        row["backends"][b] = {"fused_us": fused_us, "loop_us": loop_us,
                              "speedup": loop_us / max(fused_us, 1e-9),
                              "dispatches_fused": n_fused,
                              "dispatches_loop": n_loop}
        C.csv_row(f"multiout/dy{dy}/{b}", fused_us,
                  f"loop_us={loop_us:.1f};dispatches={n_fused}vs{n_loop}")
    row["theta"] = out["fused"].cpu().numpy()
    return row


def run(fast: bool = False, *, out: str | None = None, device=None,
        registry=None) -> dict:
    """The benchmark; returns the results and writes them as JSON to
    `out` when given."""
    device = resolve_device(device)
    rounds = 10 if fast else 30
    j_nodes, d_feat = (6, 16) if fast else (10, 32)
    n_per_node = 40 if fast else 120
    dys = (1, 4) if fast else (1, 4, 8)
    reps = 1 if fast else 3
    rows = []
    for dy in dys:
        fused_pk, scalar_pks = build_packs(dy, j_nodes, d_feat, n_per_node,
                                           device=device)
        row = multiout_row(fused_pk, scalar_pks, rounds, device=device,
                           reps=reps)
        del row["theta"]
        rows.append(row)
        if registry is not None:
            registry.gauge(f"multiout.dy{dy}.speedup_cuda_fused").set(
                row["backends"]["cuda_fused"]["speedup"])
    results = {"benchmark": ("multi-output DeKRR: fused Dy-batched solve "
                             "vs per-output scalar loop (identical data, "
                             "rtol-1e-9 parity asserted per row)"),
               "device": device_name(device), "j_nodes": j_nodes,
               "d_feat": d_feat, "rounds": rounds, "results": rows}
    if out is not None:
        write_json(results, out)
        print(f"multiout/json,0.0,wrote={out}")
    return results


if __name__ == "__main__":
    sys.exit(cli(run, __doc__))
