"""The port's nemotron-4-15b and deepseek-coder-33b against the JAX package's.

  * Every field of the two copied configs, and of their ``reduced()``
    forms, equals the JAX config's.
  * ``prefill`` plus 3 decode steps of each ``reduced()`` form, with the
    JAX parameters carried across by ``bridge.from_jax``, hold to the JAX
    ``impl="ref"`` tier in float32: logits within 1e-5 (two layers of
    float32 products summed in another order by each framework), at the
    reduced form's GQA 2 and, through ``dataclasses.replace(attn=...)``,
    at GQA 6 and 7 (the full configs' 48/8 and 56/8) at the reduced width.
  * The loss and every gradient of nemotron-4-15b's ``reduced()`` (its
    squared-ReLU MLP has no gate) hold to ``jax.value_and_grad``, and one
    ``make_train_step`` step to JAX's unjitted one.
  * The fused decode chain's GEMV plans fit a block's shared memory at
    every registered config, batch 1-64, on the H100's 132 SMs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import lm as jax_lm
from repro_torch import bridge
from repro_torch.configs import _REGISTRY, get_config
from repro_torch.configs.base import AttnCfg
from repro_torch.kernels import fused_decode as fd
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm

NAMES = ["nemotron-4-15b", "deepseek-coder-33b"]
# (H, KV) at the reduced width's head dim 16: the reduced forms' GQA 2 and
# the full configs' ratios
GQA = {2: None, 6: (12, 2), 7: (14, 2)}


def _both(name, **kw):
    return (dataclasses.replace(jax_get_config(name), **kw),
            dataclasses.replace(get_config(name), **kw))


@pytest.mark.parametrize("name", NAMES)
def test_configs_equal_jax_field_by_field(name):
    full = jax_get_config(name)
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(full)
    assert dataclasses.asdict(get_config(name + "-smoke")) == \
        dataclasses.asdict(jax_get_config(name + "-smoke")) == dataclasses.asdict(full.reduced())


def test_the_configs_as_published():
    nem, dsc = get_config("nemotron-4-15b"), get_config("deepseek-coder-33b")
    assert (nem.n_layers, nem.d_model, nem.d_ff, nem.vocab, nem.act) == \
        (32, 6144, 24576, 256_000, "sq_relu")
    assert (nem.attn.n_heads, nem.attn.n_kv_heads, nem.attn.head_dim) == (48, 8, 128)
    assert (dsc.n_layers, dsc.d_model, dsc.d_ff, dsc.vocab, dsc.act) == \
        (62, 7168, 19200, 32_256, "silu_glu")
    assert (dsc.attn.n_heads, dsc.attn.n_kv_heads, dsc.attn.head_dim) == (56, 8, 128)


def _setup(name, gqa):
    heads = GQA[gqa]
    kw = dict(compute_dtype="float32")
    jcfg, cfg = _both(name + "-smoke", **kw)
    if heads is not None:
        jcfg = dataclasses.replace(jcfg, attn=dataclasses.replace(
            jcfg.attn, n_heads=heads[0], n_kv_heads=heads[1]))
        cfg = dataclasses.replace(cfg, attn=AttnCfg(**dataclasses.asdict(jcfg.attn)))
    assert cfg.attn.n_heads // cfg.attn.n_kv_heads == gqa
    tree = jax.tree.map(np.array, jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, tree


@pytest.mark.parametrize("gqa", list(GQA))
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_jax_ref(name, gqa):
    jcfg, cfg, tree = _setup(name, gqa)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int64)
    feed = [rng.integers(0, cfg.vocab, (2, 1)).astype(np.int64) for _ in range(3)]
    cap = 24 + len(feed) + 2
    params = jax.tree.map(jnp.asarray, tree)
    jl, jc = jax_lm.prefill(jcfg, params, {"tokens": jnp.asarray(toks)}, capacity=cap,
                            impl="ref")
    want = [jl]
    for tok in feed:
        jl, jc = jax_lm.decode_step(jcfg, params, jc, jnp.asarray(tok), impl="ref")
        want.append(jl)
    model = bridge.from_jax(cfg, tree, device="cpu")
    tl, tc = lm.prefill(cfg, model, {"tokens": torch.from_numpy(toks)}, capacity=cap)
    got = [tl.clone()]
    for tok in feed:
        tl, tc = lm.decode_step(cfg, model, tc, torch.from_numpy(tok))
        got.append(tl.clone())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), atol=1e-5, rtol=1e-5)


def _batch(cfg, b=2, s=40):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def test_nemotron_loss_and_gradients_match_jax():
    jcfg, cfg, tree = _setup("nemotron-4-15b", 2)
    assert cfg.act == "sq_relu"
    batch = _batch(cfg)
    (want_loss, _), jgrads = jax.value_and_grad(
        lambda p: jax_lm.loss_fn(jcfg, p, batch, impl="ref"), has_aux=True)(tree)
    want = bridge._flat_jax(cfg, jax.tree.map(np.asarray, jgrads))
    model = bridge.from_jax(cfg, tree, device="cpu", param_dtype=torch.float32)
    loss, _ = lm.loss_fn(cfg, model, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    assert any(k.endswith("mlp.w_up") for k in got) and not any("w_gate" in k for k in got)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    for k, g in got.items():
        w = torch.from_numpy(np.asarray(want[k], dtype=np.float32))
        torch.testing.assert_close(g, w, atol=1e-4 * float(w.abs().max()) + 1e-12, rtol=0,
                                   msg=k)


def test_nemotron_train_step_matches_jax():
    jcfg, cfg, tree = _setup("nemotron-4-15b", 2)
    kw = dict(lr=1e-3, warmup=1, total_steps=10)
    _, jopt, jstep = jax_make_train_step(jcfg, impl="ref", **kw)
    opt, step_fn = make_train_step(cfg, **kw)
    batch = _batch(cfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    jparams, _, jm = jstep(jparams, jopt.init(jparams), jnp.asarray(0, jnp.int32),
                           {k: v[None] for k, v in batch.items()})
    model = bridge.from_jax(cfg, tree, device="cpu", param_dtype=torch.float32)
    m = step_fn(model, opt.init(dict(model.named_parameters())), 0,
                {k: torch.from_numpy(v[None]).long() for k, v in batch.items()})
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    want = bridge._flat_jax(cfg, jax.tree.map(np.asarray, jparams))
    for k, p in model.named_parameters():
        w = torch.from_numpy(np.asarray(want[k], dtype=np.float32))
        torch.testing.assert_close(p.detach(), w, atol=1e-5 * float(w.abs().max()), rtol=0,
                                   msg=k)


def _chain_plans(cfg, batch, sms=132, dtype=torch.bfloat16):
    """(plan, shared bytes) of qkv_rope and out_residual as the wrappers
    make them for ``cfg``'s attention sublayer at ``batch`` rows."""
    a = cfg.attn
    groups = -(-batch // fd.BATCH_GROUP)
    qkv = fd.gemv_plan(a.n_heads + 2 * a.n_kv_heads, fd.tile_width(a.head_dim), cfg.d_model,
                       groups, sms, dtype=dtype, norm=True)
    width = min(fd.OUT_WIDTH, fd.tile_width(cfg.d_model))
    out = fd.gemv_plan(-(-cfg.d_model // width), width, a.n_heads * a.head_dim, groups, sms,
                       dtype=dtype, norm=False)
    return [(qkv, fd.shared_bytes(qkv, dtype, True)), (out, fd.shared_bytes(out, dtype, False))]


@pytest.mark.parametrize("name", sorted(n for n, c in _REGISTRY.items() if c.attn is not None))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gemv_plans_fit_shared_memory_at_every_config(name, dtype):
    cfg = get_config(name)
    for batch in range(1, 65):
        for plan, nbytes in _chain_plans(cfg, batch, dtype=dtype):
            assert nbytes <= fd.SHARED_LIMIT, (name, batch, plan, nbytes)
            assert 1 <= plan.splits <= fd.MAX_SPLITS
            assert plan.splits == 1 or plan.slice % fd.K_STEP == 0


def test_gemv_plan_keeps_its_split_where_it_fits_and_doubles_where_not():
    """deepseek-coder-33b's qkv_rope at 9-16 rows: the SM rule gives one
    split of 7168 rows (238,880 bytes, over the limit); two fit.  Where
    the SM rule's plan fits, it stands (qwen2.5-3b, nemotron-4-15b)."""
    dsc, nem = get_config("deepseek-coder-33b"), get_config("nemotron-4-15b")
    (qkv, nbytes), _ = _chain_plans(dsc, 16)
    assert qkv == fd.GemvPlan(128, 3584, 2) and nbytes == 167_200
    assert fd.shared_bytes(fd.GemvPlan(128, 7168, 1), torch.bfloat16, True) == 238_880
    assert _chain_plans(nem, 16)[0] == (fd.GemvPlan(128, 6144, 1), 218_400)
    assert _chain_plans(nem, 8)[0] == (fd.GemvPlan(128, 3072, 2), 156_960)
    assert fd.gemv_plan(20, 128, 2048, 1, 132, dtype=torch.bfloat16,
                        norm=True) == fd.GemvPlan(128, 256, 8)


def test_gemv_plan_raises_where_no_split_fits():
    with pytest.raises(ValueError, match="shared memory"):
        fd.gemv_plan(8, 128, 200_000, 16, 132, dtype=torch.float32, norm=True)
