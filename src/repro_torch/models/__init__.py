"""The LLM model of the port: dense-attention transformers in the
reference's parameter and cache layouts (`repro_torch.models.model`),
over the shared layers (`repro_torch.models.layers`)."""
from repro_torch.models.model import (Model, ModelConfig, SlotSpec,
                                      init_params)

__all__ = ["Model", "ModelConfig", "SlotSpec", "init_params"]
