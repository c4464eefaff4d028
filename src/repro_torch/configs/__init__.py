"""Architecture registry of the port: the configs it serves.

``base.py`` and the four config modules are copies of ``repro.configs``
(the port imports nothing of the JAX package); the names and values are
the same, so a config picked here describes the same model there.
"""
from __future__ import annotations

from .base import ModelConfig

from . import h2o_danube3_4b, mamba2_370m, qwen2_5_3b, tiny  # noqa: E402

_REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (tiny, qwen2_5_3b, h2o_danube3_4b, mamba2_370m)}


def get_config(name: str) -> ModelConfig:
    """``"<name>-smoke"`` gives the config's ``reduced()`` form."""
    if name.endswith("-smoke"):
        return _REGISTRY[name[:-6]].reduced()
    return _REGISTRY[name]
