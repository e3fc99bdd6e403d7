"""Network topologies for decentralized learning (numpy only).

The paper (§IV) uses a connected undirected graph with J=10 nodes, each with
4 neighbors — i.e. the circulant graph C_10(1, 2). Circulant graphs get the
ring-shift slot layout in `repro_torch.dist.pack_problem`; arbitrary
connected graphs use the padded ``neighbor_table()``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """A symmetric, connected communication graph.

    Attributes:
      adjacency: [J, J] boolean numpy array, symmetric, zero diagonal.
      circulant_offsets: for circulant graphs, the positive shift set s such
        that node j is connected to (j ± s) mod J; None for general graphs.
    """

    adjacency: np.ndarray
    circulant_offsets: tuple[int, ...] | None = None

    def __post_init__(self):
        a = self.adjacency
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"adjacency must be square, got {a.shape}")
        if not np.array_equal(a, a.T):
            raise ValueError("graph must be undirected (symmetric adjacency)")
        if np.any(np.diag(a)):
            raise ValueError("no self-loops")
        if not self._connected():
            raise ValueError("graph must be connected")

    # -- basic structure ----------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return self.adjacency.shape[0]

    def neighbors(self, j: int) -> list[int]:
        return list(np.nonzero(self.adjacency[j])[0])

    def degree(self, j: int) -> int:
        return int(self.adjacency[j].sum())

    @property
    def degrees(self) -> np.ndarray:
        return self.adjacency.sum(axis=1).astype(np.int32)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max())

    @property
    def edges(self) -> list[tuple[int, int]]:
        i, j = np.nonzero(np.triu(self.adjacency))
        return list(zip(i.tolist(), j.tolist()))

    def _connected(self) -> bool:
        J = self.adjacency.shape[0]
        seen = np.zeros(J, dtype=bool)
        stack = [0]
        seen[0] = True
        while stack:
            u = stack.pop()
            for v in np.nonzero(self.adjacency[u])[0]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(int(v))
        return bool(seen.all())

    # -- padded neighbor table (for SPMD execution) --------------------------
    def neighbor_table(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (idx [J, max_degree], mask [J, max_degree]).

        idx[j, m] is the m-th neighbor of node j (or j itself where masked).
        Zero-padded rows are masked out; solver algebra must be exact under
        the mask (tested).
        """
        J, md = self.num_nodes, self.max_degree
        idx = np.zeros((J, md), dtype=np.int32)
        mask = np.zeros((J, md), dtype=bool)
        for j in range(J):
            nb = self.neighbors(j)
            idx[j, : len(nb)] = nb
            idx[j, len(nb):] = j  # self index as harmless padding
            mask[j, : len(nb)] = True
        return idx, mask


def circulant(num_nodes: int, offsets: Sequence[int] = (1, 2)) -> Topology:
    """Circulant graph C_J(offsets): node j ~ (j ± s) mod J for s in offsets.

    The paper's J=10, |N_j|=4 network is ``circulant(10, (1, 2))``.
    """
    offsets = tuple(sorted(set(int(s) for s in offsets)))
    if any(s <= 0 or s >= num_nodes for s in offsets):
        raise ValueError(f"offsets must be in (0, J), got {offsets}")
    a = np.zeros((num_nodes, num_nodes), dtype=bool)
    for j in range(num_nodes):
        for s in offsets:
            a[j, (j + s) % num_nodes] = True
            a[j, (j - s) % num_nodes] = True
    return Topology(adjacency=a, circulant_offsets=offsets)


def ring(num_nodes: int) -> Topology:
    return circulant(num_nodes, (1,))


def complete(num_nodes: int) -> Topology:
    a = ~np.eye(num_nodes, dtype=bool)
    offsets = tuple(range(1, num_nodes // 2 + 1))
    return Topology(adjacency=a, circulant_offsets=offsets)


def erdos_renyi(num_nodes: int, p: float, seed: int = 0,
                max_tries: int = 200) -> Topology:
    """Random connected G(J, p) graph (retry until connected)."""
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        a = rng.random((num_nodes, num_nodes)) < p
        a = np.triu(a, 1)
        a = a | a.T
        try:
            return Topology(adjacency=a)
        except ValueError:
            continue
    raise RuntimeError(f"could not sample a connected G({num_nodes},{p})")


def star(num_nodes: int) -> Topology:
    """Star graph — worst-case degree imbalance (stress test)."""
    a = np.zeros((num_nodes, num_nodes), dtype=bool)
    a[0, 1:] = True
    a[1:, 0] = True
    return Topology(adjacency=a)
