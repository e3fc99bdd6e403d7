"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64 routed experts top-6 + 2 shared experts
(fine-grained expert segmentation). [arXiv:2401.06066]"""
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.model import ModelConfig, SlotSpec


def spec() -> ArchSpec:
    return ArchSpec(
        config=ModelConfig(
            name="deepseek-moe-16b",
            num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
            head_dim=128, d_ff=1408, vocab_size=102400,
            slots=(SlotSpec("attn", "moe"),),
            moe_num_experts=64, moe_experts_per_token=6,
            moe_num_shared_experts=2,
            citation="arXiv:2401.06066",
        ),
        long_context_mode="swa",
    )
