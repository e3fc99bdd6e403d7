"""rwkv6-7b [ssm] — 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536. Finch: data-dependent decay. [arXiv:2404.05892]

long_500k runs natively: the recurrent state is constant-size, decode cost
is O(1) in context length.
"""
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.model import ModelConfig, SlotSpec


def spec() -> ArchSpec:
    return ArchSpec(
        config=ModelConfig(
            name="rwkv6-7b",
            num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
            d_ff=14336, vocab_size=65536,
            slots=(SlotSpec("rwkv", "rwkv_cmix"),),
            rwkv_head_dim=64,
            citation="arXiv:2404.05892",
        ),
        long_context_mode="native",
    )
