"""The comparison that decides ``correct``.

A fit's outputs, as the timed path produced them, are held against the
plain reference (`perfbench.reference`) worked out again from the same
inputs. Five numbers, each the worst over nodes and over the fits
checked:

* ``select_mismatch``: selected features that are not the reference's
  pick from the pool, row by row (an exact comparison, limit 0);
* ``sdp_rel``: S, d and P of Eq. 17 (the whole padded block of a node);
* ``inv_rel``: G of Eq. 17, the inverse;
* ``theta_rel``: θ after the rounds the program ran;
* ``pred_rel``: the test predictions.

Each relative number is max|program − reference| / max|reference| over
one node's block. The limits are the cell's, in
``limits/<workload>.json``, set from the readings given in PERF.md.
"""
from __future__ import annotations

import math

import numpy as np

NUMBERS = ("select_mismatch", "sdp_rel", "inv_rel", "theta_rel", "pred_rel")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        return math.inf
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    gap = float(np.max(np.abs(a - b))) if b.size else 0.0
    return gap / scale if scale > 0 else gap


def compare(prog: dict, ref: dict) -> dict[str, float]:
    """The five numbers for one fit (both sides in the packed layout)."""
    num_nodes = len(ref["sel"])
    mismatch = 0
    for a, b in zip(prog["sel"], ref["sel"]):
        a, b = np.asarray(a), np.asarray(b)
        mismatch += (int(np.count_nonzero(a != b)) if a.shape == b.shape
                     else max(a.size, b.size))
    node = lambda key, j: (prog[key][j] if j < len(prog[key]) else
                           np.full_like(ref[key][j], np.nan))
    return dict(
        select_mismatch=float(mismatch),
        sdp_rel=max(max(_rel(node(k, j), ref[k][j]) for k in ("s", "d", "p"))
                    for j in range(num_nodes)),
        inv_rel=max(_rel(node("g", j), ref["g"][j]) for j in range(num_nodes)),
        theta_rel=max(_rel(node("theta", j), ref["theta"][j])
                      for j in range(num_nodes)),
        pred_rel=max(_rel(node("pred", j), ref["pred"][j])
                     for j in range(num_nodes)))


def worst(readings: list[dict[str, float]],
          best: bool = False) -> dict[str, float]:
    """Each number's worst (largest) value over several fits, or with
    ``best`` its smallest; inf where no fit was checked."""
    pick = min if best else max
    return {k: pick((r[k] for r in readings), default=math.inf)
            for k in NUMBERS}
