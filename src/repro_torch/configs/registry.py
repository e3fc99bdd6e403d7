"""Architecture registry: the 10 architectures × 4 input shapes.

Each ``src/repro_torch/configs/<id>.py`` exposes ``spec() -> ArchSpec``
with its published configuration (citation in brackets) plus a
reduced smoke variant. ``--arch <id>`` in the launchers resolves through
``get_arch``. The port's own copy of the reference's registry (data
only); its model runs every decoding configuration.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.model import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


INPUT_SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    # tokens: plain LM. vlm: stub patch embeds + tokens. audio: stub frame
    # embeds only (encoder).
    input_kind: str = "tokens"
    supports_decode: bool = True        # False for encoder-only (hubert)
    # long_500k handling: native (ssm/hybrid) | swa (dense w/ sliding-window
    # variant, window below) | skip
    long_context_mode: str = "swa"
    long_context_window: int = 8192

    def shape_plan(self, shape: str) -> str:
        """'run' | 'run-swa' | 'skip' for a given input-shape name."""
        spec = INPUT_SHAPES[shape]
        if spec.kind == "decode" and not self.supports_decode:
            return "skip"
        if shape == "long_500k":
            if self.long_context_mode == "skip":
                return "skip"
            if self.long_context_mode == "swa":
                return "run-swa"
        return "run"


ARCH_IDS = [
    "qwen1_5_0_5b",
    "llava_next_mistral_7b",
    "hubert_xlarge",
    "granite_3_8b",
    "smollm_135m",
    "rwkv6_7b",
    "qwen1_5_32b",
    "deepseek_moe_16b",
    "jamba_1_5_large_398b",
    "phi3_5_moe_42b",
]

_ALIASES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "hubert-xlarge": "hubert_xlarge",
    "granite-3-8b": "granite_3_8b",
    "smollm-135m": "smollm_135m",
    "rwkv6-7b": "rwkv6_7b",
    "qwen1.5-32b": "qwen1_5_32b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
}


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def get_arch(name: str) -> ArchSpec:
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.spec()
