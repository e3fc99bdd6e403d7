from repro_torch.configs.registry import (ArchSpec, INPUT_SHAPES, ShapeSpec,
                                          get_arch, list_archs)

__all__ = ["ArchSpec", "INPUT_SHAPES", "ShapeSpec", "get_arch", "list_archs"]
