"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.model import ModelConfig, SlotSpec


def spec() -> ArchSpec:
    return ArchSpec(
        config=ModelConfig(
            name="qwen1.5-32b",
            num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
            head_dim=128, d_ff=27392, vocab_size=152064, qkv_bias=True,
            slots=(SlotSpec("attn", "dense"),),
            citation="hf:Qwen/Qwen1.5-0.5B",
        ),
        long_context_mode="swa",
    )
