"""JAX parameter pytrees -> the port's modules: `models.lm.LM`, and the
stage modules of `runtime.pipeline.lm_pipe` (`stages_from_jax`).

Takes the pytree of ``repro.models.lm.init_params`` with its leaves as
numpy arrays (nested dicts, as ``jax.tree.map(np.asarray, params)`` gives
it) and imports nothing of JAX.  The per-layer leaves under
``params["layers"]["pos<i>"]`` (one entry a position of the block
pattern: ``mixer``, ``mlp`` and an encoder-decoder's ``cross``; an MoE
``mlp`` nests ``experts`` and ``shared``) are stacked over layer periods
along their leading axis (an MoE's (P, E, D, F) experts unstack to
(E, D, F)); the bridge unstacks
period p of position i into layer ``p * len(pattern) + i`` of the
``nn.ModuleList``, and the same for ``params["enc_layers"]``.  Each value
is cast to the port parameter's dtype (for serving the compute dtype for
matrices, biases and the Mamba conv taps, float32 for norms and the Mamba
``dt_bias``, ``a_log`` and ``d_skip``; for training ``param_dtype``
throughout but the float32 ones), which is the cast the JAX code makes at
every use, so both packages compute with the same numbers.  bf16 leaves
pass through float32 on the way, because ``torch.from_numpy`` does not
take ml_dtypes' bfloat16.
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
    stacks = [("layers", cfg.n_periods, ("mixer", "cross", "mlp") if cfg.encdec
               else ("mixer", "mlp"))]
    if cfg.encdec:
        out["enc_norm"] = params["enc_norm"]
        stacks.append(("enc_layers", cfg.enc_layers // n, ("mixer", "mlp")))
    for stack, periods, parts in stacks:
        for i in range(n):
            period = params[stack][f"pos{i}"]
            for part in parts:
                for name, leaf in flat_tree(period[part]).items():
                    for p in range(periods):
                        out[f"{stack}.{p * n + i}.{part}.{name}"] = leaf[p]
    return out


def from_jax(cfg: ModelConfig, params, *, device="cuda", param_dtype=None, keep=None) -> LM:
    """A port `LM` on ``device`` holding the JAX ``params`` (numpy leaves):
    for serving (``param_dtype`` None) in the compute dtype, or as trainable
    masters of ``param_dtype`` (the JAX float32 masters as they are).
    ``keep``: as `models.lm.init_params`'s, a test of the names
    ``"embed"``, ``"final_norm"``, ``"head"`` and ``"layers.<i>"``; what it
    leaves out stays on the meta device (a rank of a pipeline over ranks
    fills only its stages)."""
    model = LM(cfg, device=resolve_device(device), param_dtype=param_dtype)
    src = _flat_jax(cfg, params)
    dst = dict(model.named_parameters())
    if src.keys() != dst.keys():
        raise ValueError(f"{cfg.name}: JAX leaves {sorted(src.keys() ^ dst.keys())} "
                         "have no counterpart")
    if keep is not None:
        for name in ("embed", "final_norm", "head"):
            held = getattr(model, name, None)
            if held is not None and not keep(name):
                setattr(model, name, torch.nn.Parameter(held.to("meta"),
                                                        requires_grad=held.requires_grad))
        for i, layer in enumerate(model.layers):
            if not keep(f"layers.{i}"):
                layer.to("meta")
        dst = dict(model.named_parameters())
    with torch.no_grad():
        for name, leaf in src.items():
            if dst[name].is_meta:
                continue
            value = torch.from_numpy(np.array(leaf, dtype=np.float32))
            if value.shape != dst[name].shape:
                raise ValueError(f"{name}: JAX shape {tuple(value.shape)}, "
                                 f"port shape {tuple(dst[name].shape)}")
            dst[name].copy_(value)
    return model


def flat_tree(tree, prefix: str = "") -> dict:
    """A nested dict of leaves as {dotted path: leaf} (``l0.mix.wq``), the
    names a module's ``named_parameters`` give the same tree."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_tree(v, path + "."))
        else:
            out[path] = v
    return out


def stages_from_jax(cfg: ModelConfig, stage_params, *, device="cuda",
                    layers_per_stage: int | None = None, stages=None) -> dict:
    """The port's stage modules ({name: module}, `lm_pipe.build_lm_stages`'s
    layout) on ``device`` holding the JAX stage parameters: the third item
    of JAX ``build_lm_stages(...)``, or {stage name: ``st.params[0]``} of a
    JAX ``LMPipeline`` (a fused stage's tree is split into its members),
    with numpy leaves.  Masters keep their dtype (float32 as float32).
    ``stages``: only these stages (one rank's of an `LMPipeline` over ranks,
    which passes their names to a ``params`` function); the others are
    neither built nor filled."""
    from .runtime.pipeline.lm_pipe import build_lm_stages
    src = {}
    for name, tree in stage_params.items():
        members = name.split("+")
        for m in members:
            src[m] = tree[m] if len(members) > 1 else tree
    names, modules = build_lm_stages(cfg, layers_per_stage=layers_per_stage,
                                     device="meta" if stages is not None else device,
                                     empty=True)
    if sorted(src) != sorted(names):
        raise ValueError(f"{cfg.name}: JAX stages {sorted(src)}, port stages {names}")
    if stages is not None:
        unknown = sorted(set(stages) - set(names))
        if unknown:
            raise ValueError(f"{cfg.name}: no stages {unknown} among {names}")
        names = [n for n in names if n in stages]
        modules = {n: modules[n].to_empty(device=resolve_device(device)) for n in names}
    with torch.no_grad():
        for name in names:
            leaves = flat_tree(src[name])
            dst = dict(modules[name].named_parameters())
            if leaves.keys() != dst.keys():
                raise ValueError(f"{name}: JAX leaves {sorted(leaves.keys() ^ dst.keys())} "
                                 "have no counterpart")
            for key, leaf in leaves.items():
                value = torch.from_numpy(np.array(leaf, dtype=np.float32))
                if value.shape != dst[key].shape:
                    raise ValueError(f"{name}.{key}: JAX shape {tuple(value.shape)}, "
                                     f"port shape {tuple(dst[key].shape)}")
                dst[key].copy_(value)
    return modules
