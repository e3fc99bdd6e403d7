"""Synthetic stand-ins for the paper's six regression datasets.

Each libsvm/UCI dataset is simulated with a generator that preserves its (d, N)
and produces a smooth nonlinear teacher — a random ground-truth function
drawn from (an RF approximation of) a Gaussian RKHS plus heteroscedastic
noise — which is exactly the model class where KRR comparisons are
meaningful. Preprocessing follows the paper: x scaled to [0,1], y to [-1,1],
50/50 train/test per node.

Partitioners implement the paper's §IV protocols:
  * non-IID by mean |y|  (sort |y| descending, deal out contiguously)
  * non-IID by ‖x‖₂      (ditto on input norms)
  * imbalanced           N_j = (2j−1)N/100 for J=10 (generalized)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.dekrr import NodeData

DATASET_SPECS: dict[str, tuple[int, int]] = {
    # name: (d, N) from Tab. 1
    "houses": (8, 20640),
    "air_quality": (13, 9357),
    "energy": (27, 19735),
    "twitter": (77, 98704),
    "toms_hardware": (96, 29179),
    "wave": (148, 63600),
}


@dataclasses.dataclass
class Dataset:
    name: str
    x: np.ndarray  # [d, N], scaled to [0, 1]
    y: np.ndarray  # [N],   scaled to [-1, 1]

    @property
    def dim(self) -> int:
        return self.x.shape[0]

    @property
    def num_samples(self) -> int:
        return self.x.shape[1]


def make_dataset(name: str, *, seed: int = 0, subsample: int | None = None,
                 noise: float = 0.05, teacher_features: int = 64,
                 teacher_components: int = 4) -> Dataset:
    """Generate the synthetic stand-in for ``name`` (see DATASET_SPECS).

    The teacher is *spatially modulated*: a soft partition-of-unity over input
    space gates M component functions, each drawn from a Gaussian RKHS with
    its own bandwidth (log-spaced). Different regions of input space are
    therefore dominated by different frequency bands — the regime real
    tabular data exhibits and the one DDRF is designed for: under non-IID
    partitions each node sees one band and benefits from selecting features
    matched to it, while data-independent shared RFF must spread its budget
    over all bands.
    """
    if name not in DATASET_SPECS:
        raise KeyError(f"unknown dataset {name!r}; have {list(DATASET_SPECS)}")
    d, n = DATASET_SPECS[name]
    if subsample is not None:
        n = min(n, subsample)
    # stable per-dataset seed (Python's hash() is randomized per process)
    name_seed = int.from_bytes(
        __import__("hashlib").md5(name.encode()).digest()[:4], "little")
    rng = np.random.default_rng(seed + name_seed % (2**31))

    # Inputs: correlated features squashed to [0,1] (tabular-like marginals).
    mix = rng.normal(size=(d, d)) / np.sqrt(d)
    raw = mix @ rng.normal(size=(d, n)) + 0.3 * rng.normal(size=(d, n))
    x = 1.0 / (1.0 + np.exp(-raw))                       # [d, N] in (0,1)

    # Soft partition of unity: softmax over random linear gates.
    m = teacher_components
    gate_w = rng.normal(size=(m, d)) * 3.0 / np.sqrt(d)
    gate_b = rng.normal(size=(m, 1))
    logits = gate_w @ (x - 0.5) + gate_b                 # [M, N]
    logits -= logits.max(axis=0, keepdims=True)
    gates = np.exp(logits)
    gates /= gates.sum(axis=0, keepdims=True)

    # Component functions: random Fourier, log-spaced bandwidths.
    sigmas = np.geomspace(0.25 * np.sqrt(d), 2.0 * np.sqrt(d), m)
    f = np.zeros(n)
    for c in range(m):
        omega = rng.normal(size=(teacher_features, d)) / sigmas[c]
        bias = rng.uniform(0, 2 * np.pi, size=(teacher_features, 1))
        coef = rng.normal(size=teacher_features) / np.sqrt(teacher_features)
        f += gates[c] * (coef @ np.cos(omega @ x + bias))

    # Heteroscedastic noise (stronger where ‖x‖ is large → non-IID splits by
    # ‖x‖ also induce noise heterogeneity across nodes, as in real sensors).
    scale = noise * (1.0 + np.linalg.norm(x, axis=0) / np.sqrt(d))
    y = f + rng.normal(size=n) * scale

    # Paper preprocessing: y → [-1, 1].
    y = 2.0 * (y - y.min()) / max(y.max() - y.min(), 1e-12) - 1.0
    return Dataset(name=name, x=x.astype(np.float64), y=y.astype(np.float64))


# ------------------------------------------------------------- partitioners
def _deal(order: np.ndarray, sizes: list[int]) -> list[np.ndarray]:
    out, start = [], 0
    for s in sizes:
        out.append(order[start:start + s])
        start += s
    return out


def equal_sizes(n: int, num_nodes: int) -> list[int]:
    base = n // num_nodes
    sizes = [base] * num_nodes
    for i in range(n - base * num_nodes):
        sizes[i] += 1
    return sizes


def imbalanced_sizes(n: int, num_nodes: int) -> list[int]:
    """Paper §IV-B2: N_j = (2j−1)/J² · N (for J=10: (2j−1)N/100)."""
    weights = np.array([2 * j - 1 for j in range(1, num_nodes + 1)], float)
    weights /= weights.sum()
    sizes = np.floor(weights * n).astype(int)
    sizes[-1] += n - sizes.sum()
    return sizes.tolist()


def partition(
    ds: Dataset,
    num_nodes: int,
    *,
    mode: str = "iid",
    sizes: list[int] | None = None,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> list[NodeData]:
    """Split a dataset across nodes. mode: iid | noniid_y | noniid_xnorm.

    The shards are float64 tensors on ``device`` (the card by default)."""
    device = resolve_device(device)
    n = ds.num_samples
    rng = np.random.default_rng(seed)
    if sizes is None:
        sizes = equal_sizes(n, num_nodes)
    if sum(sizes) != n:
        raise ValueError(f"sizes sum {sum(sizes)} != N {n}")

    if mode == "iid":
        order = rng.permutation(n)
    elif mode == "noniid_y":
        order = np.argsort(-np.abs(ds.y))      # descending mean |y| per node
    elif mode == "noniid_xnorm":
        order = np.argsort(-np.linalg.norm(ds.x, axis=0))
    else:
        raise ValueError(f"unknown partition mode {mode!r}")

    as_t = lambda a: torch.as_tensor(a, device=device)
    return [NodeData(x=as_t(ds.x[:, idx]), y=as_t(ds.y[idx]))
            for idx in _deal(order, sizes)]


def train_test_split_nodes(
    nodes: list[NodeData], *, seed: int = 0
) -> tuple[list[NodeData], list[NodeData]]:
    """Paper: each node trains on half its local data, tests on the rest.
    The halves stay on their node's device."""
    rng = np.random.default_rng(seed)
    train, test = [], []
    for nd in nodes:
        perm = rng.permutation(nd.num_samples)
        half = nd.num_samples // 2
        tr = torch.as_tensor(perm[:half], device=nd.x.device)
        te = torch.as_tensor(perm[half:], device=nd.x.device)
        train.append(NodeData(x=nd.x[:, tr], y=nd.y[tr]))
        test.append(NodeData(x=nd.x[:, te], y=nd.y[te]))
    return train, test


def pooled(nodes: list[NodeData]) -> NodeData:
    x = torch.cat([nd.x for nd in nodes], dim=1)
    y = torch.cat([nd.y.reshape(-1) for nd in nodes])
    return NodeData(x=x, y=y)
