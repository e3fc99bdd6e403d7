"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.model import ModelConfig, SlotSpec


def spec() -> ArchSpec:
    return ArchSpec(
        config=ModelConfig(
            name="phi3.5-moe-42b-a6.6b",
            num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
            head_dim=128, d_ff=6400, vocab_size=32064,
            slots=(SlotSpec("attn", "moe"),),
            moe_num_experts=16, moe_experts_per_token=2,
            citation="hf:microsoft/Phi-3.5-MoE-instruct",
        ),
        long_context_mode="swa",
    )
