"""Training launcher: the port's counterpart of `repro.launch.train`
and of the ``examples/train_lm.py`` flow, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
      --steps 200 --batch 8 --seq 256 [--full] [--ckpt PATH]

Without ``--full`` the architecture's reduced configuration trains on
the synthetic token pipeline; ``--device cpu`` runs on the CPU. One card
only: ``--mesh`` takes ``none``; the mesh runs (``single``, ``multi``)
belong to the mesh launcher, ROADMAP queue 1 item 7.
"""
from __future__ import annotations

import argparse

from repro_torch._device import resolve_device


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (the card)")
    ap.add_argument("--mesh", default="none",
                    help="none (one device); the mesh runs are not ported")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise SystemExit(f"--mesh {args.mesh}: the port trains on one "
                         f"device; the mesh launcher is ROADMAP queue 1 "
                         f"item 7 (slice 10d)")

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import (SyntheticTokenPipeline,
                                         TokenPipelineConfig)
    from repro_torch.train.loop import train_loop
    from repro_torch.train.optim import AdamWConfig

    device = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.config if args.full else spec.config.reduced()
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"vocab={cfg.vocab_size} ({'full' if args.full else 'reduced'})")

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    pipe = SyntheticTokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, batch_size=args.batch,
        seq_len=args.seq, seed=args.seed))

    _, history = train_loop(
        cfg, opt_cfg, iter(pipe), args.steps, seed=args.seed,
        ckpt_path=args.ckpt, device=device)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.4f} → {last:.4f} "
          f"({100 * (first - last) / first:.1f}% reduction)")
    return history


if __name__ == "__main__":
    main()
