"""The system under test: ``repro_torch``'s single-device ``LMServer``.

The only module of the harness that imports the program.  It builds the
program's ``ModelConfig`` from a configuration file's ``model`` section,
hands the benchmark's weights to the program's ``LM`` (every parameter a
tensor of the weights dict, nothing copied), and makes the server: the
kernel route (``impl=None``), greedy, and an ``eos_id`` no argmax can
return, so each request runs to its drawn length.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch
from torch import nn

NEVER_EMITTED = -1


def model_config(model: dict):
    from repro_torch.configs import base
    nested = {"attn": base.AttnCfg, "mamba": base.MambaCfg, "moe": base.MoECfg}
    fields = {f.name for f in dataclasses.fields(base.ModelConfig)}
    kw = {k: v for k, v in model.items() if k in fields}
    for key, cls in nested.items():
        if kw.get(key) is not None:
            kw[key] = cls(**kw[key])
    kw["block_pattern"] = tuple(tuple(p) for p in kw["block_pattern"])
    return base.ModelConfig(**kw)


def params(cfg, weights: dict):
    """The program's ``LM`` over the benchmark's tensors: built on the meta
    device, then every parameter replaced by the tensor of the same name,
    whose shape and dtype must match."""
    from repro_torch.models import lm
    model = lm.LM(cfg, device="meta")
    names = dict(model.named_parameters())
    if set(names) != set(weights):
        raise ValueError("the program's parameters and the benchmark's weights differ: "
                         f"only the program's {sorted(set(names) - set(weights))[:5]}, "
                         f"only the benchmark's {sorted(set(weights) - set(names))[:5]}")
    for name, p in names.items():
        t = weights[name]
        if tuple(p.shape) != tuple(t.shape) or p.dtype != t.dtype:
            raise ValueError(f"{name}: the program holds {tuple(p.shape)} {p.dtype}, "
                             f"the benchmark drew {tuple(t.shape)} {t.dtype}")
        *path, leaf = name.split(".")
        owner = model
        for part in path:
            owner = getattr(owner, part)
        setattr(owner, leaf, nn.Parameter(t, requires_grad=False))
    return model


def server(cfg, lm_params, max_batch: int, device):
    from repro_torch.runtime.server import LMServer
    return LMServer(cfg, max_batch=max_batch, eos_id=NEVER_EMITTED, params=lm_params,
                    temperature=0.0, impl=None, device=device)


def kernel_library():
    """Builds the program's kernel library, or loads it where this checkout
    has it built."""
    from repro_torch.kernels import build
    return build.library()


def requests(reqs):
    from repro_torch.runtime.server import Request
    return [Request(uid=r.uid, prompt=r.prompt.tolist(), max_new=r.max_new) for r in reqs]


def wrap_model(srv, before_prefill, before_decode):
    """Has ``srv`` call ``before_prefill()`` / ``before_decode()`` as each
    ``lm.prefill`` / ``lm.decode_step`` call enters, and run each call
    under a span of its name."""
    model = srv.model
    prefill, decode = model.prefill, model.decode_step

    def spanned_prefill(*a, **kw):
        before_prefill()
        with torch.profiler.record_function("lm.prefill"):
            return prefill(*a, **kw)

    def spanned_decode(*a, **kw):
        before_decode()
        with torch.profiler.record_function("lm.decode_step"):
            return decode(*a, **kw)

    srv.model = dataclasses.replace(model, prefill=spanned_prefill, decode_step=spanned_decode)


def resolve(target: str):
    """``"module:Class.attr"`` -> (owner object, attribute name); raises
    where any part is missing."""
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    if not callable(getattr(owner, attr)):
        raise TypeError(f"{target} is not callable")
    return owner, attr
