"""Batched serving engine: slot-based continuous batching over the
model's decode step (the port's counterpart of `repro.serve.engine`).

A fixed pool of ``batch_size`` slots shares one cache; requests are
admitted into free slots in waves, prefilled by teacher-forcing their
prompt through ``decode_step`` (no separate prefill path), and decoded
greedily until EOS or ``max_new_tokens``. Every slot of a wave steps in
lockstep from position 0; a slot whose prompt is exhausted starts
generating while longer prompts are still being fed.

On the card the decode attention of every ``attn`` layer runs the
flash-decode kernel (``backend="cuda"``); ``backend="torch"`` runs the
plain chunked attention instead. The other mixers (the sliding-window
ring, Mamba, RWKV-6) and ffns (MoE, channel mix) run as the model's
decode step runs them on either backend. Each step's next tokens come
back to the host in one copy.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.model import Model, ModelConfig, init_params
from repro_torch.serve.admission import AdmissionQueue, LatencyRecorder


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 32
    eos_id: int | None = None
    # filled by the engine
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Greedy continuous-batching engine over `Model.decode_step`.

    ``params`` is the model's parameter pytree; without it the engine
    draws its own from ``seed`` on ``device`` (the card unless the caller
    names another). ``decode_steps`` counts the decode steps of the last
    `run`, and ``latency`` holds its per-request latencies.
    """

    def __init__(self, cfg: ModelConfig, params=None, *, batch_size: int = 4,
                 max_seq: int = 256, seed: int = 0, device=None,
                 backend: str = "cuda"):
        if backend not in L.DECODE_BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{L.DECODE_BACKENDS}")
        self.cfg = cfg
        if params is None:
            gen = torch.Generator(resolve_device(device)).manual_seed(seed)
            params = init_params(cfg, gen)
        self.model = Model(cfg, params)
        self.params = params
        self.device = self.model.device
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.backend = backend
        self.decode_steps = 0
        self.latency = LatencyRecorder()

    def run(self, requests: Iterable[Request]) -> list[Request]:
        """Serve all requests; returns them with .output filled. Latency
        percentiles for the run are in `self.latency.report()`."""
        queue = AdmissionQueue()
        self.latency.reset()
        self.decode_steps = 0
        for r in requests:
            queue.admit(r, uid=r.uid, width=1, now=self.latency.now())
        finished: list[Request] = []
        b = self.batch_size
        with torch.inference_mode():
            while len(queue):
                admitted = queue.take_wave(b)
                wave = [a.item for a in admitted]
                self._run_wave(wave)
                for r in wave:
                    r.done = True
                    finished.append(r)
                self.latency.record_wave(admitted, self.latency.now())
        return finished

    def _run_wave(self, wave: list[Request]) -> None:
        b = self.batch_size
        cache = self.model.init_cache(b, self.max_seq)
        max_prompt = max(len(r.prompt) for r in wave)
        horizon = min(self.max_seq,
                      max_prompt + max(r.max_new_tokens for r in wave))
        active = [i < len(wave) for i in range(b)]
        cursors = [0] * b
        for t in range(horizon):
            col = []
            for i in range(b):
                if not active[i]:
                    col.append(0)
                    continue
                r = wave[i]
                if cursors[i] < len(r.prompt):
                    col.append(int(r.prompt[cursors[i]]))
                elif r.output:
                    col.append(int(r.output[-1]))
                else:
                    col.append(int(r.prompt[-1]))
            toks = torch.tensor(col, dtype=torch.long,
                                device=self.device)[:, None]
            logits, cache = self.model.decode_step(cache, toks, t,
                                                   backend=self.backend)
            self.decode_steps += 1
            nxt = logits.argmax(dim=-1).tolist()      # one host copy
            for i in range(b):
                if not active[i]:
                    continue
                r = wave[i]
                cursors[i] += 1
                if cursors[i] >= len(r.prompt):
                    tok = nxt[i]
                    r.output.append(tok)
                    if ((r.eos_id is not None and tok == r.eos_id)
                            or len(r.output) >= r.max_new_tokens):
                        r.done = True
                        active[i] = False
            if not any(active):
                break
