"""Training launcher: the port's counterpart of `repro.launch.train`
and of the ``examples/train_lm.py`` flow, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
      --steps 200 --batch 8 --seq 256 [--full] [--ckpt PATH] \\
      [--mesh single --data 16 --model 16]

Without ``--full`` the architecture's reduced configuration trains on
the synthetic token pipeline; ``--device cpu`` runs on the CPU.
``--mesh none`` trains on one device. ``--mesh single`` (a (data,
model) grid) and ``--mesh multi`` (a (2, data, model) grid with the pod
axis) train on a `repro_torch.launch.mesh.make_production_mesh` over the
launched process group: torchrun's (its environment), or one rank of
this process when nothing launched it. The train state and the batches
are DTensors placed by `repro_torch.launch.specs.input_specs` (bf16
parameters, the sharding rules' placements). A world size that does not
match the mesh raises, naming both.
"""
from __future__ import annotations

import argparse
import os
import socket

from repro_torch._device import resolve_device


def _init_group(device) -> bool:
    """The default process group: torchrun's when its environment names
    one, else this process as the one rank of a group at a free local
    port. True when this call made it."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
        return True
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    return True


def _mesh_train(args, spec, cfg, device) -> list[dict]:
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.data.tokens import (SyntheticTokenPipeline,
                                         TokenPipelineConfig)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import ShardingRules, distribute
    from repro_torch.launch.specs import input_specs
    from repro_torch.obs.metrics import perf_clock
    from repro_torch.train.optim import AdamWConfig

    made = _init_group(device)
    try:
        mesh = make_production_mesh(
            multi_pod=args.mesh == "multi", data=args.data,
            model=args.model, device_type=device.type)
        rules = ShardingRules(mesh)
        opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 5))
        pair = input_specs(dataclasses.replace(spec, config=cfg),
                           ShapeSpec("cli", args.seq, args.batch, "train"),
                           rules, device=device, seed=args.seed,
                           opt_cfg=opt_cfg)
        state = pair["args"][0]
        b_shard = pair["in_shardings"][1]
        step_fn = pair["fn"]
        pipe = iter(SyntheticTokenPipeline(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, batch_size=args.batch,
            seq_len=args.seq, seed=args.seed)))
        print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
              f"{dist.get_world_size()} rank(s), policy "
              f"{pair['rules'].policy}")
        history: list[dict] = []
        t0 = perf_clock()
        for i in range(args.steps):
            batch = distribute({k: torch.as_tensor(v, device=device)
                                for k, v in next(pipe).items()}, b_shard)
            state, metrics = step_fn(state, batch)
            if (i + 1) % 10 == 0 or i == 0:
                m = {k: float(v.full_tensor() if hasattr(v, "full_tensor")
                              else v) for k, v in metrics.items()}
                m["step"] = i + 1
                m["wall_s"] = perf_clock() - t0
                history.append(m)
                print(f"step {i+1:5d}  loss {m['loss']:.4f}  "
                      f"gnorm {m['grad_norm']:.2f}  lr {m['lr']:.2e}  "
                      f"({m['wall_s']:.1f}s)")
            if args.ckpt and (i + 1) % 200 == 0:
                from repro_torch.train.checkpoint import save_checkpoint
                save_checkpoint(args.ckpt, {"params": state.params,
                                            "opt": state.opt}, step=i + 1)
        return history
    finally:
        if made:
            dist.destroy_process_group()


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (the card)")
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--data", type=int, default=16,
                    help="the mesh's data axis (--mesh single|multi)")
    ap.add_argument("--model", type=int, default=16,
                    help="the mesh's model axis (--mesh single|multi)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

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

    if args.mesh != "none":
        history = _mesh_train(args, spec, cfg, device)
    else:
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
