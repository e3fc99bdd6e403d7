"""hubert-xlarge [audio] — 48L d_model=1280 16H (GQA kv=16) d_ff=5120
vocab=504 (k-means cluster targets), encoder-only, same arch as wav2vec2.
[arXiv:2106.07447]

Backbone only: the mel-spectrogram + conv feature extractor frontend is a
stub — callers supply frame embeddings [B, S, d]. Training = masked
prediction over the 504 cluster vocabulary.
Encoder-only ⇒ no autoregressive decode (decode shapes skipped).
"""
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.model import ModelConfig, SlotSpec


def spec() -> ArchSpec:
    return ArchSpec(
        config=ModelConfig(
            name="hubert-xlarge",
            num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
            head_dim=80, d_ff=5120, vocab_size=504,
            slots=(SlotSpec("attn", "dense"),),
            is_encoder=True, act="gelu",
            citation="arXiv:2106.07447",
        ),
        input_kind="audio",
        supports_decode=False,
        long_context_mode="skip",
    )
