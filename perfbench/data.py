"""Frozen copy of the stand-in datasets and the §IV partitions.

A NumPy copy of `repro_torch.data.synthetic` (`make_dataset`,
`equal_sizes`, `imbalanced_sizes`, `partition`, `train_test_split_nodes`)
as it stood when the benchmark was defined, so that a change to the
program cannot change the benchmark's inputs. It returns host arrays;
the harness stages them on the card. `tests/test_perfbench_data.py`
holds it bit for bit against the program's generator at a small N.

Each of the paper's six datasets (arXiv 2405.07791, Table 1) is
simulated with its (d, N): x in [0, 1], y in [-1, 1], a spatially
modulated random-feature teacher plus heteroscedastic noise.
"""
from __future__ import annotations

import hashlib

import numpy as np

DATASET_SPECS: dict[str, tuple[int, int]] = {
    "houses": (8, 20640),
    "air_quality": (13, 9357),
    "energy": (27, 19735),
    "twitter": (77, 98704),
    "toms_hardware": (96, 29179),
    "wave": (148, 63600),
}


def make_dataset(name: str, *, seed: int = 0, subsample: int | None = None,
                 noise: float = 0.05, teacher_features: int = 64,
                 teacher_components: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """(x [d, N], y [N]) of the stand-in for ``name``, float64."""
    if name not in DATASET_SPECS:
        raise KeyError(f"unknown dataset {name!r}; have {list(DATASET_SPECS)}")
    d, n = DATASET_SPECS[name]
    if subsample is not None:
        n = min(n, subsample)
    name_seed = int.from_bytes(hashlib.md5(name.encode()).digest()[:4],
                               "little")
    rng = np.random.default_rng(seed + name_seed % (2**31))

    mix = rng.normal(size=(d, d)) / np.sqrt(d)
    raw = mix @ rng.normal(size=(d, n)) + 0.3 * rng.normal(size=(d, n))
    x = 1.0 / (1.0 + np.exp(-raw))

    m = teacher_components
    gate_w = rng.normal(size=(m, d)) * 3.0 / np.sqrt(d)
    gate_b = rng.normal(size=(m, 1))
    logits = gate_w @ (x - 0.5) + gate_b
    logits -= logits.max(axis=0, keepdims=True)
    gates = np.exp(logits)
    gates /= gates.sum(axis=0, keepdims=True)

    sigmas = np.geomspace(0.25 * np.sqrt(d), 2.0 * np.sqrt(d), m)
    f = np.zeros(n)
    for c in range(m):
        omega = rng.normal(size=(teacher_features, d)) / sigmas[c]
        bias = rng.uniform(0, 2 * np.pi, size=(teacher_features, 1))
        coef = rng.normal(size=teacher_features) / np.sqrt(teacher_features)
        f += gates[c] * (coef @ np.cos(omega @ x + bias))

    scale = noise * (1.0 + np.linalg.norm(x, axis=0) / np.sqrt(d))
    y = f + rng.normal(size=n) * scale
    y = 2.0 * (y - y.min()) / max(y.max() - y.min(), 1e-12) - 1.0
    return x.astype(np.float64), y.astype(np.float64)


def equal_sizes(n: int, num_nodes: int) -> list[int]:
    base = n // num_nodes
    sizes = [base] * num_nodes
    for i in range(n - base * num_nodes):
        sizes[i] += 1
    return sizes


def imbalanced_sizes(n: int, num_nodes: int) -> list[int]:
    """Paper §IV-B2: N_j = (2j−1)/J² · N (for J = 10: (2j−1)N/100)."""
    weights = np.array([2 * j - 1 for j in range(1, num_nodes + 1)], float)
    weights /= weights.sum()
    sizes = np.floor(weights * n).astype(int)
    sizes[-1] += n - sizes.sum()
    return sizes.tolist()


def partition(x: np.ndarray, y: np.ndarray, num_nodes: int, *,
              mode: str = "iid", sizes: list[int] | None = None,
              seed: int = 0) -> list[tuple[np.ndarray, np.ndarray]]:
    """Split (x, y) across nodes. mode: iid | noniid_y | noniid_xnorm."""
    n = x.shape[1]
    rng = np.random.default_rng(seed)
    if sizes is None:
        sizes = equal_sizes(n, num_nodes)
    if sum(sizes) != n:
        raise ValueError(f"sizes sum {sum(sizes)} != N {n}")
    if mode == "iid":
        order = rng.permutation(n)
    elif mode == "noniid_y":
        order = np.argsort(-np.abs(y))
    elif mode == "noniid_xnorm":
        order = np.argsort(-np.linalg.norm(x, axis=0))
    else:
        raise ValueError(f"unknown partition mode {mode!r}")
    out, start = [], 0
    for s in sizes:
        idx = order[start:start + s]
        out.append((x[:, idx], y[idx]))
        start += s
    return out


def train_test_split_nodes(nodes, *, seed: int = 0):
    """Each node trains on half its local data and tests on the rest."""
    rng = np.random.default_rng(seed)
    train, test = [], []
    for x, y in nodes:
        perm = rng.permutation(x.shape[1])
        half = x.shape[1] // 2
        train.append((x[:, perm[:half]], y[perm[:half]]))
        test.append((x[:, perm[half:]], y[perm[half:]]))
    return train, test


def sqrt_proportional_d(sizes, dbar: int) -> list[int]:
    """D_j = √N_j · J·D̄ / Σ√N_j (paper §IV-B2), rounded, at least 4."""
    w = np.sqrt(np.asarray(sizes, float))
    d = np.maximum((w * len(w) * dbar / w.sum()).round().astype(int), 4)
    return d.tolist()
