"""The served weights, drawn on the device from the seed in a few large calls.

Every leaf of the model that the configuration's sublayer kinds name
(`perfbench.kinds`), in the dtype it is served in: matrices bf16, drawn
normal with std ``fan_in ** -0.5``, one draw for every configuration; the
embedding with std 1, so that each token moves the residual stream (at
std 0.02 a random decoder settles into repeating one token); norm weights
float32 at ``1 + 0.1 * normal``, so that a norm whose weight is dropped
shows.  Leaves of one dtype and std sit side by side in one flat buffer,
filled by calls of at most 2**30 elements; each leaf is a view.  The
program and the reference are handed the same tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import reference

CHUNK = 1 << 30
EMBED_STD = 1.0
NORM_STD = 0.1


def leaves(model: dict) -> dict:
    """name -> (shape, init) for the whole model, under the names the
    weights dict uses: ``embed``, ``final_norm``, ``head`` and
    ``layers.<i>.<slot>.<leaf>``."""
    out = dict(reference.kind("embed_head").leaves(model))
    for i in range(model["n_layers"]):
        for slot, name in zip(reference.SLOTS, reference.layer_kinds(model, i)):
            for leaf, spec in reference.kind(name).leaves(model).items():
                out[f"layers.{i}.{slot}.{leaf}"] = spec
    return out


def _group(shape, init: str):
    if init == "norm":
        return torch.float32, NORM_STD
    if init == "embed":
        return torch.bfloat16, EMBED_STD
    return torch.bfloat16, shape[0] ** -0.5


def seed64(seed: int, stream: int) -> int:
    """A 63-bit seed for stream ``stream`` of run seed ``seed`` (any integer)."""
    state = np.random.SeedSequence([seed % 2 ** 64, stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31 ^ int(state[1])) & (2 ** 63 - 1)


class Weights(dict):
    """name -> tensor; ``flats`` holds the buffers the tensors are views of,
    as (dtype, std, buffer)."""
    flats: list


@torch.no_grad()
def _fill(flats, seed: int, device) -> None:
    gen = torch.Generator(device=device).manual_seed(seed64(seed, 1))
    for dtype, std, flat in flats:
        for lo in range(0, flat.numel(), CHUNK):
            flat[lo:lo + CHUNK].normal_(0.0, std, generator=gen)
        if dtype == torch.float32:
            flat.add_(1.0)


def make(model: dict, seed: int, device) -> Weights:
    """The weights of ``model`` from ``seed``, on ``device``."""
    groups: dict = {}
    for name, (shape, init) in leaves(model).items():
        groups.setdefault(_group(shape, init), []).append((name, shape))
    out = Weights()
    out.flats = []
    for (dtype, std), members in sorted(groups.items(), key=lambda g: (str(g[0][0]), g[0][1])):
        flat = torch.empty(sum(math.prod(s) for _, s in members), dtype=dtype, device=device)
        out.flats.append((dtype, std, flat))
        off = 0
        for name, shape in members:
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape)
            off += n
    _fill(out.flats, seed, device)
    return out


def refill(weights: Weights, seed: int) -> None:
    """Draw ``weights`` anew from ``seed``, in place: what `make` gives for it."""
    _fill(weights.flats, seed, weights.flats[0][2].device)


def nbytes(weights: dict) -> int:
    return sum(t.numel() * t.element_size() for t in weights.values())
