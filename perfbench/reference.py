"""The plain float32 reference of a served decoder, in blocks that fit.

It imports ``torch`` and the sublayer kinds of ``perfbench.kinds`` and
nothing of the program.  It takes the benchmark's own weights (bf16 on
the card, drawn from the seed), casts one layer at a time to float32 and
runs every sequence through that layer before the next: the card holds
the served weights, one layer in float32 and each sequence's activations.

A sequence is what the server made of a request: its prompt right-aligned
in the round's bucket after pads of token 0, which are attended, then the
tokens served, fed back.  ``logits`` scores the positions from which the
served tokens came.

``quant="fp8"`` is the control, the reference computed as an fp8 GEMM
computes: every matrix weight through float8 e4m3 with a scale a column
(the output's), every activation that enters a product with one through
e4m3 with a scale a row, products summed in float32.  Attention's own
products and the norms stay in float32.
"""
from __future__ import annotations

import importlib

import torch

SLOTS = ("mixer", "mlp")


def kind(name: str):
    return importlib.import_module(f"perfbench.kinds.{name}")


def layer_kinds(model: dict, i: int) -> list[str]:
    period = model["layer_kinds"]
    return period[i % len(period)]


def _fp8(t, dim: int):
    """``t`` through float8 e4m3, one scale along ``dim``'s slices."""
    fmax = torch.finfo(torch.float8_e4m3fn).max
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / fmax
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _cast(t, quant: str | None):
    t = t.float()
    if quant is None or t.dim() < 2:
        return t
    if quant != "fp8":
        raise ValueError(f"no control precision {quant!r}")
    return _fp8(t, 0)


def _fp8_mm(x, w):
    """An fp8 GEMM's product: the activations' rows through e4m3 (``w`` is
    already), summed in float32."""
    return _fp8(x, -1) @ w


def _weights(weights: dict, prefix: str, quant):
    n = len(prefix)
    return {k[n:]: _cast(v, quant) for k, v in weights.items() if k.startswith(prefix)}


@torch.no_grad()
def logits(model: dict, weights: dict, seqs: list, first_scored: list[int], *,
           quant: str | None = None) -> list:
    """Float32 logits (n_i, V) of each sequence ``seqs[i]`` (a 1-d integer
    tensor on the weights' device) at positions ``first_scored[i]`` to its
    end."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        mm = torch.matmul if quant is None else _fp8_mm
        top = kind("embed_head")
        emb = weights["embed"] if quant is None else _cast(weights["embed"], quant)
        xs = [top.embed({"embed": emb}, s) for s in seqs]
        del emb
        for i in range(model["n_layers"]):
            for slot, name in zip(SLOTS, layer_kinds(model, i)):
                w = _weights(weights, f"layers.{i}.{slot}.", quant)
                k = kind(name)
                xs = [k.forward(model, w, x, mm) for x in xs]
                del w
        w = {"final_norm": weights["final_norm"].float(), "head": _cast(weights["head"], quant)}
        return [top.logits(model, w, x[f:], mm) for x, f in zip(xs, first_scored)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
