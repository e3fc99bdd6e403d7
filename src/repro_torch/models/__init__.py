"""The LLM model of the port: attention, sliding-window, Mamba and RWKV-6
mixers with dense, MoE and channel-mix ffns in the reference's parameter
and cache layouts (`repro_torch.models.model`), over the shared layers
(`repro_torch.models.layers`) and the mixers' modules (`moe`, `ssm`,
`rwkv`)."""
from repro_torch.models.model import (Model, ModelConfig, SlotSpec,
                                      init_params)

__all__ = ["Model", "ModelConfig", "SlotSpec", "init_params"]
