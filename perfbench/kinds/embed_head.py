"""The token embedding, the final norm and the untied output head."""
from __future__ import annotations

import torch

from .attn import BF16, F32, rmsnorm


def leaves(model: dict) -> dict:
    d, v = model["d_model"], model["vocab"]
    return {"embed": ((v, d), "embed"), "final_norm": ((d,), "norm"),
            "head": ((d, v), "normal")}


def embed(w: dict, tokens):
    return w["embed"][tokens].float()


def logits(model: dict, w: dict, x, mm=torch.matmul):
    """x (n, D) float32 -> (n, V)."""
    return mm(rmsnorm(x, w["final_norm"], model["norm_eps"]), w["head"])


def work(model: dict, rows: float) -> tuple[float, float]:
    """Embedding rows read, the final norm and the head over ``rows``
    positions (the last of each prompt, or one a live row a step)."""
    d, v = model["d_model"], model["vocab"]
    return 2.0 * rows * d * v, BF16 * d * v + F32 * d + rows * BF16 * 2 * d + rows * BF16 * v
