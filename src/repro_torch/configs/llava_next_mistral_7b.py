"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000, anyres tiling. [hf:llava-hf/llava-v1.6-mistral-7b-hf]

The transformer BACKBONE only (Mistral-7B decoder). The vision frontend
(SigLIP/CLIP ViT + anyres tiling + projector) is a stub: callers supply
pre-projected patch embeddings [B, S_img, d], which are prepended to the
text tokens.
"""
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.model import ModelConfig, SlotSpec


def spec() -> ArchSpec:
    return ArchSpec(
        config=ModelConfig(
            name="llava-next-mistral-7b",
            num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
            head_dim=128, d_ff=14336, vocab_size=32000,
            slots=(SlotSpec("attn", "dense"),),
            citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
        ),
        input_kind="vlm",
        long_context_mode="swa",
    )
