"""The paper's technique on top of the architecture zoo: frozen-backbone
features → per-node DDRF selection → DeKRR-DDRF consensus, the
counterpart of `examples/decentralized_readout.py`.

Ten nodes each hold a non-IID shard of (sequence → scalar) regression
data; the features are the backbone's pooled logits (the first 64 of the
sequence-mean logits of the port's `Model` at the registry's
``reduced()`` configuration of ``--arch``, with seeded weights). Because
the decision-function consensus never needs identical feature maps, each
node's RF head adapts to its local feature distribution. Node 9, which
holds the smallest targets, is then fitted on its own data alone and
compared with its consensus fit on the pooled test set.

    PYTHONPATH=src python -m repro_torch.examples.decentralized_readout \\
        [--arch smollm_135m] [--num-seqs 600] [--seq 32] [--device cpu]

The draws (weights, tokens, w_true, the noise and the DDRF pools) are
seeded `torch.Generator` draws on the run's device; `run` takes any of
them, so a check can pass the reference's.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core import (DeKRRConfig, DeKRRSolver, NodeData, circulant,
                              rse, select_features)
from repro_torch.core.rff import featurize
from repro_torch.models.model import Model, init_params

J = 10
POOLED = 64          # features kept of the pooled logits
BATCH = 64           # sequences a forward
D_FEAT = 16
SIGMA = 2.0
CANDIDATE_RATIO = 10
LAM = 1e-6
C_NEI_OVER_N = 0.01


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def pooled_features(model: Model, tokens: torch.Tensor) -> torch.Tensor:
    """[N, 64] float64: the first 64 of each sequence's mean logits, the
    backbone run in batches of 64 sequences."""
    with torch.no_grad():
        feats = [model.forward(tokens=tokens[i:i + BATCH])[0].mean(dim=1)
                 for i in range(0, tokens.shape[0], BATCH)]
    return torch.cat(feats)[:, :POOLED].to(torch.float64)


def readout(feats: torch.Tensor, w_true: torch.Tensor, noise: torch.Tensor,
            *, fmaps=None) -> dict:
    """{rse, local_rse, consensus_rse}: the DeKRR-DDRF readout's test RSE
    over the ten nodes (limit point), and node 9's local-only and
    consensus fits on the pooled test set. y = tanh(feats·w_true) +
    0.05·noise, split by |y| (largest first) into ten shards, each half
    train, half test; ``fmaps`` replaces the seeded DDRF draw."""
    device = feats.device
    y = torch.tanh(feats @ w_true) + 0.05 * noise
    order = torch.argsort(-torch.abs(y), stable=True)
    x_all, y_all = feats[order].T, y[order]            # [64, N], [N]
    per = feats.shape[0] // J
    train, test = [], []
    for j in range(J):
        xj = x_all[:, j * per:(j + 1) * per]
        yj = y_all[j * per:(j + 1) * per]
        h = per // 2
        train.append(NodeData(x=xj[:, :h], y=yj[:h]))
        test.append(NodeData(x=xj[:, h:], y=yj[h:]))
    if fmaps is None:
        gen = _gen(4, device)
        fmaps = [select_features(gen, POOLED, D_FEAT, SIGMA, train[j].x,
                                 train[j].y, method="energy",
                                 candidate_ratio=CANDIDATE_RATIO)
                 for j in range(J)]
    ntr = sum(t.num_samples for t in train)
    solver = DeKRRSolver(circulant(J, (1, 2)), fmaps, train,
                         DeKRRConfig(lam=LAM, c_nei=C_NEI_OVER_N * ntr),
                         device=device)
    st = solver.solve_exact()
    ys = torch.cat([t.y for t in test])
    pred = torch.cat([solver.predict(st.theta, test[j].x, node=j)
                      for j in range(J)])
    out = {"rse": rse(pred, ys)}
    # local-only comparison for the starved node
    fmap = solver.feature_maps[J - 1]
    z = featurize(fmap, train[J - 1].x)
    eye = torch.eye(z.shape[0], dtype=z.dtype, device=device)
    th = torch.linalg.solve(z @ z.T + LAM * z.shape[1] * eye,
                            z @ train[J - 1].y)
    pooled_x = torch.cat([t.x for t in test], dim=1)
    out["local_rse"] = rse(th @ featurize(fmap, pooled_x), ys)
    out["consensus_rse"] = rse(solver.predict(st.theta, pooled_x,
                                              node=J - 1), ys)
    return out


def run(arch: str = "smollm_135m", num_seqs: int = 600, seq: int = 32,
        device=None, *, params=None, tokens=None, w_true=None, noise=None,
        fmaps=None, verbose: bool = False) -> dict:
    """The example: the pooled features ("feats") and `readout`'s RSEs.
    ``params`` (e.g. `interop.lm_params_from_arrays` of the reference's),
    ``tokens`` [num_seqs, seq], ``w_true`` [64], ``noise`` [num_seqs] and
    ``fmaps`` replace the seeded draws."""
    device = resolve_device(device)
    cfg = get_arch(arch).config.reduced()
    if params is None:
        params = init_params(cfg, _gen(0, device))
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (num_seqs, seq),
                               generator=_gen(1, device), device=device)
    feats = pooled_features(Model(cfg, params), tokens.to(device))
    kw = dict(dtype=torch.float64, device=device)
    if w_true is None:
        w_true = torch.randn((POOLED,), generator=_gen(2, device), **kw)
    if noise is None:
        noise = torch.randn((feats.shape[0],), generator=_gen(3, device),
                            **kw)
    out = readout(feats, w_true.to(device), noise.to(device), fmaps=fmaps)
    if verbose:
        print(f"backbone={cfg.name}  DeKRR-DDRF readout RSE = "
              f"{out['rse']:.4f} over {J} nodes")
        print(f"starved node on pooled test: local-only "
              f"{out['local_rse']:.3f} → consensus "
              f"{out['consensus_rse']:.3f}")
    return dict(out, feats=feats)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--num-seqs", type=int, default=600)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(args.arch, args.num_seqs, args.seq, args.device, verbose=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
