"""The dense feed-forward sublayer, pre-norm, residual.

``act`` "silu_glu" (Llama's SwiGLU, deepseek-coder-33b):
``(silu(h @ w_gate) * (h @ w_up)) @ w_down``; "sq_relu" (nemotron-4-15b's
squared ReLU, not gated): ``relu(h @ w_up) ** 2 @ w_down``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attn import BF16, F32, rmsnorm


def _mats(model: dict) -> int:
    return 3 if model["act"] == "silu_glu" else 2


def leaves(model: dict) -> dict:
    d, f = model["d_model"], model["d_ff"]
    out = {"norm": ((d,), "norm")}
    if model["act"] == "silu_glu":
        out["w_gate"] = ((d, f), "normal")
    out["w_up"] = ((d, f), "normal")
    out["w_down"] = ((f, d), "normal")
    return out


def forward(model: dict, w: dict, x, mm=torch.matmul):
    h = rmsnorm(x, w["norm"], model["norm_eps"])
    act = model["act"]
    if act == "silu_glu":
        y = F.silu(mm(h, w["w_gate"])) * mm(h, w["w_up"])
    elif act == "sq_relu":
        y = torch.square(F.relu(mm(h, w["w_up"])))
    else:
        raise ValueError(f"no reference for activation {act!r}")
    return x + mm(y, w["w_down"])


def _work(model: dict, rows: float) -> tuple[float, float]:
    d, f, m = model["d_model"], model["d_ff"], _mats(model)
    flops = 2.0 * rows * m * d * f
    nbytes = BF16 * m * d * f + F32 * d + rows * BF16 * 2 * d
    return flops, nbytes


def decode_work(model: dict, lengths) -> tuple[float, float]:
    """One decode call over the live rows: the weights once, each row in and out."""
    return _work(model, len(lengths))


def prefill_work(model: dict, prompt_lens) -> tuple[float, float]:
    return _work(model, float(sum(prompt_lens)))
