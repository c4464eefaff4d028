"""The float32 reference against the port's own routes, on the CPU at the
configurations' ``reduced()`` widths: prefill logits at the last position
and decode logits through the cache, prompts right-aligned in a padded
bucket whose pads are attended, as the server runs them."""
import json

import numpy as np
import pytest
import torch

from perfbench import reference
from perfbench.harness import port, spec, weights

CONFIGS = ["deepseek-coder-33b", "nemotron-4-15b"]


def reduced(name: str, dtype: str = "float32") -> dict:
    """The configuration at small widths, its kinds and activation kept."""
    m = json.loads((spec.ROOT / "perfbench" / "configs" / f"{name}.json").read_text())["model"]
    m.update(n_layers=2, d_model=64, d_ff=128, vocab=512, compute_dtype=dtype)
    m["attn"].update(n_heads=4, n_kv_heads=2, head_dim=16)
    return m


def padded(prompts, bucket):
    toks = np.zeros((len(prompts), bucket), np.int64)
    for i, p in enumerate(prompts):
        toks[i, bucket - len(p):] = p
    return torch.from_numpy(toks)


@pytest.mark.parametrize("impl", [None, "ref"])
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_port_in_float32(name, impl):
    from repro_torch.models import lm
    model = reduced(name)
    w = {k: v.float() for k, v in weights.make(model, 2 ** 31 + 7, "cpu").items()}
    cfg = port.model_config(model)
    params = port.params(cfg, w)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model["vocab"], n) for n in (5, 17, 30)]
    bucket, steps = 32, 6
    toks = padded(prompts, bucket)
    fed = torch.from_numpy(rng.integers(0, model["vocab"], (len(prompts), steps)))
    with torch.no_grad():
        logits, cache = lm.prefill(cfg, params, {"tokens": toks}, capacity=bucket + steps,
                                   impl=impl)
        got = [logits[:, -1]]
        for s in range(steps):
            logits, cache = lm.decode_step(cfg, params, cache, fed[:, s:s + 1], impl=impl)
            got.append(logits[:, -1])
    got = torch.stack(got, dim=1)                        # (B, steps + 1, V)
    seqs = [torch.cat([toks[i], fed[i]]) for i in range(len(prompts))]
    want = reference.logits(model, w, seqs, [bucket - 1] * len(prompts))
    for i in range(len(prompts)):
        scale = float(want[i].abs().max())
        assert torch.allclose(got[i].float(), want[i][:steps + 1], atol=2e-4 * scale, rtol=0)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_sees_each_kind_of_weight(name):
    """Every leaf changes the reference's logits: none is read and dropped."""
    model = reduced(name)
    w = {k: v.float() for k, v in weights.make(model, 3, "cpu").items()}
    seq = [torch.arange(1, 20)]
    base = reference.logits(model, w, seq, [10])[0]
    for leaf in ("embed", "final_norm", "head", "layers.1.mixer.norm", "layers.0.mixer.wk",
                 "layers.1.mixer.wo", "layers.0.mlp.norm", "layers.1.mlp.w_up",
                 "layers.0.mlp.w_down"):
        moved = dict(w)
        moved[leaf] = w[leaf] * 1.5
        assert not torch.allclose(reference.logits(model, moved, seq, [10])[0], base), leaf


def test_control_is_coarser_than_bf16():
    """The control's float8 weights move the logits more than bf16 ones do."""
    model = reduced("deepseek-coder-33b")
    w = {k: v.float() for k, v in weights.make(model, 4, "cpu").items()}
    seq = [torch.arange(3, 40)]
    want = reference.logits(model, w, seq, [0])[0]
    bf16 = {k: v.bfloat16().float() for k, v in w.items()}
    near = (reference.logits(model, bf16, seq, [0])[0] - want).abs().max()
    low = (reference.logits(model, w, seq, [0], quant="fp8")[0] - want).abs().max()
    assert low > 4 * near
