"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave.
[arXiv:2403.19887]

Period of 8 slots: slot 0 is attention, slots 1–7 Mamba; MoE replaces the
dense FFN on every other slot. long_500k runs natively — only 9 of 72
layers hold a KV cache (sequence-sharded over the data axis); the Mamba
states are constant-size.
"""
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.model import ModelConfig, SlotSpec


def spec() -> ArchSpec:
    slots = tuple(
        SlotSpec("attn" if i == 0 else "mamba",
                 "moe" if i % 2 == 1 else "dense")
        for i in range(8)
    )
    return ArchSpec(
        config=ModelConfig(
            name="jamba-1.5-large-398b",
            num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
            head_dim=128, d_ff=24576, vocab_size=65536,
            slots=slots,
            moe_num_experts=16, moe_experts_per_token=2,
            ssm_state_dim=16, ssm_conv_width=4, ssm_expand=2,
            citation="arXiv:2403.19887",
        ),
        long_context_mode="native",
    )
