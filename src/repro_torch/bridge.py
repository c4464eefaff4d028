"""JAX parameter pytree -> the port's `models.lm.LM`.

Takes the pytree of ``repro.models.lm.init_params`` with its leaves as
numpy arrays (nested dicts, as ``jax.tree.map(np.asarray, params)`` gives
it) and imports nothing of JAX.  The per-layer leaves under
``params["layers"]["pos<i>"]`` (one entry a position of the block
pattern) are stacked over layer periods along their leading axis; the
bridge unstacks period p of position i into layer ``p * len(pattern) +
i`` of the ``nn.ModuleList``.  Each value is cast to the port parameter's
dtype (the compute dtype for matrices, biases and the Mamba conv taps,
float32 for norms and the Mamba ``dt_bias``, ``a_log`` and ``d_skip``),
which is the cast the JAX code makes at every use, so both packages
compute with the same numbers.  bf16 leaves pass
through float32 on the way, because ``torch.from_numpy`` does not take
ml_dtypes' bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .configs.base import ModelConfig
from .models.lm import LM


def _flat_jax(cfg: ModelConfig, params) -> dict:
    """The JAX leaves under the port's parameter names."""
    out = {"embed": params["embed"], "final_norm": params["final_norm"]}
    if not cfg.tie_embeddings:
        out["head"] = params["head"]
    n = len(cfg.block_pattern)
    for i in range(n):
        period = params["layers"][f"pos{i}"]
        for part in ("mixer", "mlp"):
            for name, leaf in period[part].items():
                for p in range(cfg.n_periods):
                    out[f"layers.{p * n + i}.{part}.{name}"] = leaf[p]
    return out


def from_jax(cfg: ModelConfig, params, *, device="cuda") -> LM:
    """A port `LM` on ``device`` holding the JAX ``params`` (numpy leaves)."""
    model = LM(cfg, device=resolve_device(device))
    src = _flat_jax(cfg, params)
    dst = dict(model.named_parameters())
    if src.keys() != dst.keys():
        raise ValueError(f"{cfg.name}: JAX leaves {sorted(src.keys() ^ dst.keys())} "
                         "have no counterpart")
    with torch.no_grad():
        for name, leaf in src.items():
            value = torch.from_numpy(np.array(leaf, dtype=np.float32))
            if value.shape != dst[name].shape:
                raise ValueError(f"{name}: JAX shape {tuple(value.shape)}, "
                                 f"port shape {tuple(dst[name].shape)}")
            dst[name].copy_(value)
    return model
