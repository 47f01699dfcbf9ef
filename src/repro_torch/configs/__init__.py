"""Architecture registry: the 10 assigned configs + the paper's own models.

``get_config("gemma-7b")`` accepts dashed ids (the ``--arch`` flag form).
"""

from .base import (INPUT_SHAPES, InputShape, MLAConfig, ModelConfig,
                   MoEConfig, SSMConfig)

from .gemma_7b import CONFIG as _gemma_7b
from .starcoder2_15b import CONFIG as _starcoder2_15b
from .jamba_v0_1_52b import CONFIG as _jamba
from .phi3_5_moe_42b import CONFIG as _phi35_moe
from .whisper_tiny import CONFIG as _whisper_tiny
from .qwen3_32b import CONFIG as _qwen3_32b
from .paligemma_3b import CONFIG as _paligemma_3b
from .xlstm_1_3b import CONFIG as _xlstm_13b
from .qwen3_4b import CONFIG as _qwen3_4b
from .deepseek_v3_671b import CONFIG as _deepseek_v3
from .paper_models import PAPER_MODELS

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        _gemma_7b, _starcoder2_15b, _jamba, _phi35_moe, _whisper_tiny,
        _qwen3_32b, _paligemma_3b, _xlstm_13b, _qwen3_4b, _deepseek_v3,
    ]
}

ALL_MODELS: dict[str, ModelConfig] = {**ARCHS, **PAPER_MODELS}


def get_config(name: str) -> ModelConfig:
    key = name.strip()
    if key in ALL_MODELS:
        return ALL_MODELS[key]
    # tolerate underscore/dash variants
    norm = key.replace("_", "-").lower()
    for k, v in ALL_MODELS.items():
        if k.lower() == norm:
            return v
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL_MODELS)}")


__all__ = ["ARCHS", "ALL_MODELS", "PAPER_MODELS", "INPUT_SHAPES",
           "InputShape", "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
           "get_config"]
