"""Training of the port's LM: the loss, AdamW, the train step and loop,
and msgpack checkpoints in the reference's format
(`repro_torch.train.checkpoint`)."""
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.step import (TrainState, lm_loss, make_prefill,
                                    make_serve_step, make_train_step,
                                    train_state_init)

__all__ = [
    "AdamWConfig", "TrainState", "adamw_init", "adamw_update", "lm_loss",
    "make_prefill", "make_serve_step", "make_train_step", "train_state_init",
]
