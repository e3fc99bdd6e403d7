"""Operations and bytes of one DeKRR-DDRF fit, and the card's peaks.

Counts are of the algorithm's work on the live shapes (each node's D_j
features and N_j columns), the same whatever implements it: padded or
ragged layout, resident or streamed route, hand kernel or torch ops.
Bytes count each input read once and each output written once per
launch. A cosine counts as one operation.

Peaks: NVIDIA H100 SXM data sheet, dense: 67 TFLOP/s in float64 on the
tensor cores (and float32 outside them), 3.35 TB/s of HBM3, at the full
power limit of 700 W; the run prints the card's own limit beside them.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


@dataclasses.dataclass
class FitShape:
    """The live shapes of one fit."""

    d: int                          # input dimension
    dims: list[int]                 # D_j
    n_train: list[int]              # N_j
    n_test: list[int]
    neighbours: list[list[int]]     # N_j, in slot order
    candidates: list[int]           # F0_j, the pool size
    rounds: int = 0
    chunk: int = 32                 # rounds per solve launch
    word: int = 8                   # bytes a value (float64)

    def pairs(self):
        """(i, k): node i's map on node k's data, for i = k or i ~ k."""
        for j, nb in enumerate(self.neighbours):
            yield j, j
            for q in nb:
                yield j, q


def _featurize(dim_f: int, d: int, n: int) -> float:
    """Z = s·cos(Ω X + b): the product, bias, cosine and scale."""
    return 2.0 * dim_f * d * n + 3.0 * dim_f * n


def _sym_gram(dim_f: int, n: int) -> float:
    """Z Zᵀ, the upper triangle and diagonal."""
    return float(dim_f) * (dim_f + 1) * n


def ddrf_ops(sh: FitShape) -> float:
    """Energy scoring of every pool: cos(Ω X + b), alignment with y,
    square. Top-D selection is a sort and counts no operations."""
    return sum(2.0 * f0 * sh.d * n + 2.0 * f0 * n + 2.0 * f0 * n
               for f0, n in zip(sh.candidates, sh.n_train))


def pack_ops(sh: FitShape) -> float:
    """Eq. 17: every Z_{i,k} once, the Gram blocks of A_j and S_j, d_j,
    the P_{j,p} products, A_j's sum and its inverse (2 D_j³)."""
    dims, n = sh.dims, sh.n_train
    ops = sum(_featurize(dims[i], sh.d, n[k]) for i, k in sh.pairs())
    for j, nb in enumerate(sh.neighbours):
        dj = dims[j]
        ops += _sym_gram(dj, n[j]) + 2.0 * dj * n[j]
        for q in nb:
            ops += _sym_gram(dj, n[q])
            ops += 2.0 * dj * dims[q] * n[j] + 2.0 * dj * dims[q] * n[q]
        ops += (len(nb) + 2.0) * dj * dj + 2.0 * dj**3
    return ops


def round_ops(sh: FitShape) -> float:
    """One Eq. 19 round: G_j (d_j + S_j θ_j + Σ P_{j,p} θ_p)."""
    return sum(2.0 * dj * (2 * dj + sum(sh.dims[q] for q in nb))
               for dj, nb in zip(sh.dims, sh.neighbours))


def predict_ops(sh: FitShape) -> float:
    return sum(_featurize(dj, sh.d, n) + 2.0 * dj * n
               for dj, n in zip(sh.dims, sh.n_test))


def fit_ops(sh: FitShape) -> float:
    """The whole fit at ``sh.rounds`` rounds."""
    return (ddrf_ops(sh) + pack_ops(sh) + sh.rounds * round_ops(sh)
            + predict_ops(sh))


def gram_launches(sh: FitShape) -> list[tuple[float, float]]:
    """(operations, bytes) of each Gram launch of a fit: every node's own
    block with Z yᵀ, then node j's map on each neighbour's data."""
    dims, n, d = sh.dims, sh.n_train, sh.d
    own_ops = sum(_featurize(dj, d, nj) + _sym_gram(dj, nj) + 2.0 * dj * nj
                  for dj, nj in zip(dims, n))
    own_bytes = sh.word * sum(dj * d + dj + d * nj + nj + dj * dj + dj
                              for dj, nj in zip(dims, n))
    cross = [(j, q) for j, nb in enumerate(sh.neighbours) for q in nb]
    if not cross:
        return [(own_ops, own_bytes)]
    cross_ops = sum(_featurize(dims[j], d, n[q]) + _sym_gram(dims[j], n[q])
                    for j, q in cross)
    maps = {j for j, _ in cross}
    data = {q for _, q in cross}
    cross_bytes = sh.word * (sum(dims[j] * d + dims[j] for j in maps)
                             + sum(d * n[q] for q in data)
                             + sum(dims[j] ** 2 for j, _ in cross))
    return [(own_ops, own_bytes), (cross_ops, cross_bytes)]


def solve_launches(sh: FitShape) -> list[tuple[float, float]]:
    """(operations, bytes) of each chain launch: ``chunk`` rounds a
    launch, the last one shorter. A launch reads G, S, P (live blocks), d
    and θ0 once and writes θ once."""
    full, rest = divmod(sh.rounds, sh.chunk)
    per_launch = [sh.chunk] * full + ([rest] if rest else [])
    live = sum(2 * dj * dj + 3 * dj + sum(dj * sh.dims[q] for q in nb)
               for dj, nb in zip(sh.dims, sh.neighbours))
    ops = round_ops(sh)
    return [(r * ops, sh.word * live) for r in per_launch]


def least_seconds(launches: list[tuple[float, float]]) -> float:
    """Σ over launches of the larger of ops/peak and bytes/bandwidth."""
    return sum(max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
               for ops, nbytes in launches)
