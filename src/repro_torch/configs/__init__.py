"""Architecture registry of the port: the configs it serves.

``base.py`` and the eleven config modules are copies of ``repro.configs``
(the port imports nothing of the JAX package); the names and values are
the same, so a config picked here describes the same model there.
``ARCHS`` and `all_cells` are the JAX registry's, in its order.
"""
from __future__ import annotations

from dataclasses import replace

from .base import SHAPES, ModelConfig, cell_is_runnable

from . import (deepseek_coder_33b, h2o_danube3_4b, internvl2_26b,  # noqa: E402
               jamba_1_5_large, llama4_maverick, llama4_scout, mamba2_370m,
               nemotron4_15b, qwen2_5_3b, seamless_m4t_medium, tiny)

_REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (mamba2_370m, h2o_danube3_4b, deepseek_coder_33b,
                                      nemotron4_15b, qwen2_5_3b, jamba_1_5_large,
                                      llama4_maverick, llama4_scout, internvl2_26b,
                                      seamless_m4t_medium, tiny)}

ARCHS = tuple(n for n in _REGISTRY if not n.startswith("tiny"))


def get_config(name: str) -> ModelConfig:
    """``"<name>-smoke"`` gives the config's ``reduced()`` form."""
    if name.endswith("-smoke"):
        return _REGISTRY[name[:-6]].reduced()
    return _REGISTRY[name]


def first_layers(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` cut to its first ``n_layers`` layers, in its order, at full
    width: whole periods of ``block_pattern``, or, below one period, the
    pattern's first ``n_layers`` entries as the one period (a config's
    pattern must divide its layers, and the bridge, the optimizer's leaf
    groups and the pipelines work in periods)."""
    n = len(cfg.block_pattern)
    if n_layers < n:
        return replace(cfg, n_layers=n_layers, block_pattern=cfg.block_pattern[:n_layers])
    if n_layers % n:
        raise ValueError(f"{cfg.name}: {n_layers} layers are not whole periods of {n}")
    return replace(cfg, n_layers=n_layers)


def all_cells():
    """All (arch, shape name, runnable, why not) cells of ``ARCHS`` x ``SHAPES``."""
    out = []
    for a in ARCHS:
        cfg = _REGISTRY[a]
        for s in SHAPES.values():
            ok, why = cell_is_runnable(cfg, s)
            out.append((a, s.name, ok, why))
    return out
