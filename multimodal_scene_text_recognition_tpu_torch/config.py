"""Model configuration: the fields of the JAX package's ``ModelConfig`` that
the greedy serving path reads, with the same defaults (JAX counterpart:
core/config.py)."""

from __future__ import annotations

import string
from dataclasses import dataclass

# 94 printable characters: string.printable minus the 6 trailing whitespace
# controls.
DEFAULT_CHARS: str = string.printable[:-6]


@dataclass(frozen=True)
class ModelConfig:
    use_tps: bool = True
    embed_dim: int = 256
    hidden_dim: int = 512
    img_h: int = 32
    img_w: int = 100
    input_channels: int = 1
    num_fiducial: int = 20
    enc_layers: int = 6
    dec_layers: int = 6
    num_heads: int = 8
    ff_dim: int = 2048
    num_obj_classes: int = 2000
    max_overlap_objs: int = 15
    # the greedy loop runs only as the fused decode kernel; the scan
    # stepper and early stop are not ported yet
    decode_early_stop: bool = False
    decode_fused: bool = False
    max_text_length: int = 25
    chars: str = DEFAULT_CHARS
    compute_dtype: str = "bfloat16"

    @property
    def num_classes(self) -> int:
        # [GO], [s], [PAD] + charset
        return 3 + len(self.chars)

    @property
    def num_cols(self) -> int:
        # encoder column count: backbone width for a 100-wide crop
        return self.img_w // 4 + 1


# The flagship that serving runs: bf16 compute, whole-loop fused decode.
FLAGSHIP = ModelConfig(decode_fused=True)
