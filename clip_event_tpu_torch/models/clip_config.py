"""The CLIP model's configuration (counterpart of `CLIPConfig` in
`clip_event_tpu/models/clip.py`), its presets and the text tower's param
keys, in a module of their own: the weight converter
(`models/convert.py`) and the serving bundle's loader (`engine/export.py`)
need them and no model code. `models.clip` re-exports every name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    image_resolution: int
    vision_layers: Union[int, Tuple[int, int, int, int]]
    vision_width: int
    vision_patch_size: Optional[int]
    context_length: int
    vocab_size: int
    transformer_width: int
    transformer_heads: int
    transformer_layers: int

    @property
    def is_vit(self) -> bool:
        return isinstance(self.vision_layers, int)

    @property
    def vision_heads(self) -> int:
        if self.is_vit:
            return self.vision_width // 64
        return self.vision_width * 32 // 64

    @property
    def grid_size(self) -> int:
        if not self.is_vit:
            raise ValueError("grid_size is defined for the ViT tower only")
        return self.image_resolution // self.vision_patch_size


VIT_B32 = CLIPConfig(512, 224, 12, 768, 32, 77, 49408, 512, 8, 12)
VIT_B16 = CLIPConfig(512, 224, 12, 768, 16, 77, 49408, 512, 8, 12)
VIT_L14 = CLIPConfig(768, 224, 24, 1024, 14, 77, 49408, 768, 12, 12)
RN50 = CLIPConfig(1024, 224, (3, 4, 6, 3), 64, None, 77, 49408, 512, 8, 12)
RN101 = CLIPConfig(512, 224, (3, 4, 23, 3), 64, None, 77, 49408, 512, 8, 12)
RN50X4 = CLIPConfig(640, 288, (4, 6, 10, 6), 80, None, 77, 49408, 640, 10, 12)

TEXT_KEYS = (
    "token_embedding", "positional_embedding", "text_transformer", "ln_final",
    "text_projection",
)

