"""DeKRR-DDRF in plain NumPy, node by node.

Notation of the paper (Z_{i,j} = Z_i(X_j) ∈ R^{D_i × N_j}, columns are
samples; c̃ = c / (N |N̂_j|) with |N̂_j| = degree + 1):

  G_j = [ (1/N + 2c̃_{j,self} + |N_j| c̃_{j,nei}) Z_{j,j} Z_{j,j}ᵀ + (λ/J) I
          + Σ_{p∈N_j} c̃_{p,nei} Z_{j,p} Z_{j,p}ᵀ ]⁻¹
  d_j = (1/N) Z_{j,j} y_j
  S_j = 2 c̃_{j,self} Z_{j,j} Z_{j,j}ᵀ
  P_{j,p} = c̃_{j,nei} Z_{j,j} Z_{p,j}ᵀ + c̃_{p,nei} Z_{j,p} Z_{p,p}ᵀ
  θ_j ← G_j ( d_j + S_j θ_j + Σ_{p∈N_j} P_{j,p} θ_p )

with cos_bias features z(x) = √(2/D) cos(ωᵀx + b). ``dtype`` sets the
precision of every operation (float64 as the configuration states;
float32 is the benchmark's control). Nodes are worked on in a pool of
threads (NumPy's elementwise loops and products release the interpreter
lock); the arithmetic of each node does not depend on it.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def energy_select(omega, bias, x, y, num_features: int) -> np.ndarray:
    """Indices of the top ``num_features`` pool rows by energy score
    ((1/N) Σ_i y_i cos(ωᵀx_i + b))², in a stable descending order."""
    proj = omega @ x
    proj += bias[:, None]
    align = np.cos(proj, out=proj) @ y
    scores = align**2 / (x.shape[1] ** 2)
    return np.argsort(-scores, kind="stable")[:num_features]


def features(omega, bias, x) -> np.ndarray:
    scale = np.sqrt(np.asarray(2.0 / omega.shape[0], dtype=x.dtype))
    return np.cos(omega @ x + bias[:, None]) * scale


def aux(maps, train, neighbours, c_nei: float, c_self_ratio: float,
        lam: float, pool: ThreadPoolExecutor | None = None):
    """Eq. 17 for every node: lists G_j, d_j, S_j and P_j [slot] (in the
    order of ``neighbours[j]``)."""
    num_nodes = len(maps)
    n_total = sum(x.shape[1] for x, _ in train)
    pairs = sorted({(j, j) for j in range(num_nodes)}
                   | {pq for j in range(num_nodes) for q in neighbours[j]
                      for pq in ((j, q), (q, j))})
    run = pool.map if pool is not None else map
    z = dict(zip(pairs, run(lambda ij: features(*maps[ij[0]],
                                                train[ij[1]][0]), pairs)))
    zf = lambda i, j: z[i, j]

    def ct(j, c):
        return c / (n_total * (len(neighbours[j]) + 1))

    g, d, s, p = [], [], [], []
    for j in range(num_nodes):
        deg = len(neighbours[j])
        ct_self, ct_nei = ct(j, c_self_ratio * c_nei), ct(j, c_nei)
        gram = zf(j, j) @ zf(j, j).T
        a = (1.0 / n_total + 2.0 * ct_self + deg * ct_nei) * gram
        a = a + (lam / num_nodes) * np.eye(gram.shape[0], dtype=gram.dtype)
        for q in neighbours[j]:
            a = a + ct(q, c_nei) * (zf(j, q) @ zf(j, q).T)
        g.append(np.linalg.inv(a))
        d.append(zf(j, j) @ train[j][1] / n_total)
        s.append(2.0 * ct_self * gram)
        p.append([ct_nei * (zf(j, j) @ zf(q, j).T)
                  + ct(q, c_nei) * (zf(j, q) @ zf(q, q).T)
                  for q in neighbours[j]])
    return g, d, s, p


def rounds(g, d, s, p, neighbours, num_rounds: int) -> list[np.ndarray]:
    """``num_rounds`` synchronous Eq. 19 rounds from θ = 0."""
    theta = [np.zeros_like(dj) for dj in d]
    for _ in range(num_rounds):
        theta = [g[j] @ (d[j] + s[j] @ theta[j]
                         + sum(pjq @ theta[q]
                               for pjq, q in zip(p[j], neighbours[j])))
                 for j in range(len(d))]
    return theta


def fit(pool, train, test, dims, neighbours, *, c_nei: float,
        c_self_ratio: float, lam: float, num_rounds: int,
        dtype=np.float64, workers: int | None = None) -> dict:
    """One fit from the benchmark's inputs, in the ragged layout: the
    selected pool indices, G, d, S, P, θ after ``num_rounds`` rounds and
    each node's test predictions."""
    cast = lambda a: np.asarray(a, dtype=dtype)
    train = [(cast(x), cast(y)) for x, y in train]
    nodes = range(len(pool))
    with ThreadPoolExecutor(workers or os.cpu_count() or 1) as ex:
        cands = [(cast(om), cast(b)) for om, b in pool]
        sel = list(ex.map(lambda j: energy_select(*cands[j], *train[j],
                                                  dims[j]), nodes))
        maps = [(cands[j][0][sel[j]], cands[j][1][sel[j]]) for j in nodes]
        g, d, s, p = aux(maps, train, neighbours, c_nei, c_self_ratio, lam,
                         ex)
        theta = rounds(g, d, s, p, neighbours, num_rounds)
        pred = list(ex.map(lambda j: theta[j] @ features(
            *maps[j], cast(test[j][0])), nodes))
    return dict(sel=sel, g=g, d=d, s=s, p=p, theta=theta, pred=pred)


def pad(ref: dict, d_max: int) -> dict:
    """The ragged reference in the packed layout ([J, D_max, …], zeros
    past each D_j), float64."""
    num_nodes, k_slots = len(ref["g"]), len(ref["p"][0])
    g = np.zeros((num_nodes, d_max, d_max))
    s = np.zeros_like(g)
    p = np.zeros((num_nodes, k_slots, d_max, d_max))
    d = np.zeros((num_nodes, d_max))
    theta = np.zeros_like(d)
    for j in range(num_nodes):
        dj = ref["g"][j].shape[0]
        g[j, :dj, :dj] = ref["g"][j]
        s[j, :dj, :dj] = ref["s"][j]
        d[j, :dj] = ref["d"][j]
        theta[j, :dj] = ref["theta"][j]
        for k, pjq in enumerate(ref["p"][j]):
            p[j, k, :pjq.shape[0], :pjq.shape[1]] = pjq
    return dict(sel=ref["sel"], g=g, d=d, s=s, p=p, theta=theta,
                pred=[np.asarray(v, np.float64) for v in ref["pred"]])
