"""The training loop: the port's counterpart of `repro.train.loop`."""
from __future__ import annotations

from typing import Callable, Iterable

import torch

from repro_torch._device import resolve_device
from repro_torch.models.model import ModelConfig
from repro_torch.obs.metrics import perf_clock
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.step import (TrainState, make_train_step,
                                    train_state_init)


def train_loop(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    batches: Iterable[dict],
    num_steps: int,
    *,
    seed: int = 0,
    log_every: int = 10,
    ckpt_path: str | None = None,
    ckpt_every: int = 200,
    log_fn: Callable[[str], None] = print,
    state: TrainState | None = None,
    device=None,
) -> tuple[TrainState, list[dict]]:
    """``num_steps`` train steps over ``batches`` (dicts of numpy arrays,
    moved to the state's device one at a time). Without ``state`` the
    parameters are drawn from ``seed`` on ``device`` (the card unless the
    caller names another). Step 1 and every ``log_every``-th step read
    the metrics back to the host, log them and add them to the history
    with ``step`` and ``wall_s``; no other step reads anything back.
    Every ``ckpt_every`` steps ``{"params", "opt"}`` is saved to
    ``ckpt_path``. The state is updated in place and returned with the
    history."""
    if state is None:
        device = resolve_device(device)
        state = train_state_init(
            cfg, opt_cfg, torch.Generator(device).manual_seed(seed),
            device=device)
    device = state.step.device
    step_fn = make_train_step(cfg, opt_cfg)
    history: list[dict] = []
    t0 = perf_clock()
    it = iter(batches)
    for i in range(num_steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(it).items()}
        state, metrics = step_fn(state, batch)
        if (i + 1) % log_every == 0 or i == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i + 1
            m["wall_s"] = perf_clock() - t0
            history.append(m)
            log_fn(f"step {i+1:5d}  loss {m['loss']:.4f}  "
                   f"gnorm {m['grad_norm']:.2f}  lr {m['lr']:.2e}  "
                   f"({m['wall_s']:.1f}s)")
        if ckpt_path and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_path, {"params": state.params,
                                        "opt": state.opt}, step=i + 1)
    return state, history
