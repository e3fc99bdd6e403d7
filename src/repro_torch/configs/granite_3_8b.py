"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.model import ModelConfig, SlotSpec


def spec() -> ArchSpec:
    return ArchSpec(
        config=ModelConfig(
            name="granite-3-8b",
            num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
            head_dim=128, d_ff=12800, vocab_size=49155,
            slots=(SlotSpec("attn", "dense"),),
            citation="hf:ibm-granite/granite-3.0-2b-base",
        ),
        long_context_mode="swa",
    )
