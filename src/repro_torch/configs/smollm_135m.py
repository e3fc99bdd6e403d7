"""smollm-135m [dense] — 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152, llama-arch small, tied embeddings.
[hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.model import ModelConfig, SlotSpec


def spec() -> ArchSpec:
    return ArchSpec(
        config=ModelConfig(
            name="smollm-135m",
            num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
            head_dim=64, d_ff=1536, vocab_size=49152,
            slots=(SlotSpec("attn", "dense"),),
            tie_embeddings=True,
            citation="hf:HuggingFaceTB/SmolLM-135M",
        ),
        long_context_mode="swa",
    )
