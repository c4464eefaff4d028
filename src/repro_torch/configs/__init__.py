"""Architecture registry of the port: the configs it serves.

``base.py`` and the ten config modules are copies of ``repro.configs``
(the port imports nothing of the JAX package); the names and values are
the same, so a config picked here describes the same model there.
"""
from __future__ import annotations

from .base import ModelConfig

from . import (deepseek_coder_33b, h2o_danube3_4b, internvl2_26b,  # noqa: E402
               llama4_maverick, llama4_scout, mamba2_370m, nemotron4_15b, qwen2_5_3b,
               seamless_m4t_medium, tiny)

_REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (tiny, qwen2_5_3b, h2o_danube3_4b, mamba2_370m,
                                      nemotron4_15b, deepseek_coder_33b,
                                      seamless_m4t_medium, internvl2_26b, llama4_scout,
                                      llama4_maverick)}


def get_config(name: str) -> ModelConfig:
    """``"<name>-smoke"`` gives the config's ``reduced()`` form."""
    if name.endswith("-smoke"):
        return _REGISTRY[name[:-6]].reduced()
    return _REGISTRY[name]
