"""Serving launcher: batched greedy decoding with a KV cache, on the card
by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1_5_0_5b \\
      --full --batch 8 --prompt-len 32 --gen 64

The weights are the port's seeded initialisation (``--seed``), not a
checkpoint. ``--device cpu`` runs on the CPU, where the decode attention
runs the flash-decode kernel's plain version.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch
from repro_torch.models.model import Model, init_params
from repro_torch.obs.metrics import perf_clock


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_0_5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    if not spec.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only — no decode path")
    cfg = spec.config if args.full else spec.config.reduced()
    device = resolve_device(args.device)
    model = Model(cfg, init_params(
        cfg, torch.Generator(device).manual_seed(args.seed)))

    b = args.batch
    max_len = args.prompt_len + args.gen
    prompt = torch.randint(
        0, cfg.vocab_size, (b, args.prompt_len), device=device,
        generator=torch.Generator(device).manual_seed(args.seed + 1))
    cache = model.init_cache(b, max_len)

    out = []
    with torch.inference_mode():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = perf_clock()
        # prefill by repeated decode (teacher forcing the prompt)
        for t in range(args.prompt_len):
            logits, cache = model.decode_step(cache, prompt[:, t:t + 1], t)
        tok = logits.argmax(dim=-1)[:, None]
        for t in range(args.prompt_len, max_len):
            out.append(tok)
            logits, cache = model.decode_step(cache, tok, t)
            tok = logits.argmax(dim=-1)[:, None]
        gen = torch.cat(out, dim=1).cpu()
        dt = perf_clock() - t0
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"{cfg.name} on {where}: generated "
          f"{tuple(gen.shape)} tokens in {dt:.2f}s "
          f"({b * max_len / dt:.1f} tok/s incl. prefill)")
    print("first sequence:", gen[0, :16].tolist(), "...")


if __name__ == "__main__":
    main()
