"""The port's encoder-decoder family and prefix frontend against the JAX
package's, on the CPU.

Configs: ``seamless-m4t-medium-smoke`` (2 encoder and 2 decoder layers,
GQA 2), the same with ``n_kv_heads = n_heads`` (GQA 1, as at full width),
and ``internvl2-26b-smoke`` with 8 prefix embeddings ahead of the tokens
and without them (the text-only serve).  Parameters come from the JAX
``init_params`` with every norm made random with numpy (so each is
exercised) and reach the port through ``bridge.from_jax``; the frames and
prefix embeddings are drawn with numpy.  The encoder reads 11 frames, not
the config's 8: the cross caches take the frames' length.  The JAX side
runs its ``impl="ref"`` tier as the oracle; the port its kernel route (the
kernels' plain versions on the CPU) and its own ``ref`` route.

Tolerances, as ``test_torch_model.py`` and ``test_torch_train.py`` state
them: logits float32 1e-4, bf16 0.1; caches float32 1e-4; the loss
float32 1e-5 relative and each gradient within 1e-4 of its leaf's largest
JAX entry; bf16 loss 2e-3 relative and each leaf's gradient within 0.2 of
its JAX norm; two train steps' parameters within 1e-5 of their largest
entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import blocks as jax_blocks
from repro.models import lm as jax_lm
from repro.runtime.server import LMServer as JaxServer
from repro.runtime.server import Request as JaxRequest
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.runtime.pipeline import DecodePipeline
from repro_torch.runtime.server import LMServer, Request
from test_torch_server import TIE, _margins, _requests

# (case, config, with the prefix embeddings)
CASES = {"seamless": ("seamless-m4t-medium-smoke", False),
         "seamless-gqa1": ("seamless-m4t-medium-smoke-gqa1", False),
         "internvl-prefix": ("internvl2-26b-smoke", True),
         "internvl-text": ("internvl2-26b-smoke", False)}
TOL = {"float32": 1e-4, "bfloat16": 1e-1}
FRAMES = 11


def _config(get, name, **kw):
    """``<name>-gqa1``: the config with as many KV heads as query heads."""
    if name.endswith("-gqa1"):
        cfg = get(name[:-5])
        return dataclasses.replace(
            cfg, attn=dataclasses.replace(cfg.attn, n_kv_heads=cfg.attn.n_heads), **kw)
    return dataclasses.replace(get(name), **kw)


def _setup(case, compute_dtype="float32", **kw):
    name, prefix = CASES[case]
    jcfg = _config(jax_get_config, name, compute_dtype=compute_dtype, **kw)
    cfg = _config(get_config, name, compute_dtype=compute_dtype, **kw)
    tree = jax.tree.map(np.array, jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for stack in ("layers", "enc_layers"):
        for pos in tree.get(stack, {}).values():
            for part in pos.values():
                for key in part:
                    if key.endswith("norm"):
                        part[key] = (1.0 + rng.normal(scale=0.1, size=part[key].shape)
                                     ).astype(np.float32)
    for key in ("final_norm", "enc_norm"):
        if key in tree:
            tree[key] = (1.0 + rng.normal(scale=0.1, size=tree[key].shape)).astype(np.float32)
    return jcfg, cfg, tree, prefix


def _batch(cfg, prefix, b=2, s=16, seed=2, lead=()):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (*lead, b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (*lead, b, s)).astype(np.int32)}
    if cfg.encdec:
        batch["frames"] = rng.normal(size=(*lead, b, FRAMES, cfg.d_model)).astype(np.float32)
    if prefix:
        batch["prefix_embeds"] = rng.normal(
            size=(*lead, b, cfg.num_prefix, cfg.d_model)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# -- the bridge ---------------------------------------------------------------
@pytest.mark.parametrize("case", ["seamless", "internvl-prefix"])
def test_bridge_maps_every_leaf(case):
    _, cfg, tree, _ = _setup(case)
    model = bridge.from_jax(cfg, tree, device="cpu")
    names = dict(model.named_parameters())
    assert names.keys() == bridge._flat_jax(cfg, tree).keys()
    if cfg.encdec:
        assert len(model.enc_layers) == cfg.enc_layers == 2
        for key in ("enc_norm", "enc_layers.1.mixer.wq", "enc_layers.0.mlp.w_down",
                    "layers.1.cross.norm", "layers.0.cross.wk", "layers.1.cross.wo"):
            assert key in names, key
        np.testing.assert_array_equal(_np(names["layers.1.cross.wv"]),
                                      tree["layers"]["pos0"]["cross"]["wv"][1])
        np.testing.assert_array_equal(_np(names["enc_norm"]), tree["enc_norm"])
    else:
        assert model.enc_layers is None and model.enc_norm is None
        assert not any(".cross." in k for k in names)


def test_bridge_refuses_a_tree_without_the_encoder():
    _, _, tree, _ = _setup("internvl-prefix")
    _, cfg, _, _ = _setup("seamless")
    with pytest.raises((ValueError, KeyError)):
        bridge.from_jax(cfg, tree, device="cpu")


# -- logits_fn, forward, prefill and decode -----------------------------------
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_forward_match_jax(case, dtype):
    jcfg, cfg, tree, prefix = _setup(case, dtype)
    batch = _batch(cfg, prefix)
    want = jax_lm.logits_fn(jcfg, tree, batch, impl="ref", last_only=False)
    _, jn_prefix = jax_lm.forward(jcfg, tree, batch, impl="ref")
    model = bridge.from_jax(cfg, tree, device="cpu")
    with torch.no_grad():
        got = lm.logits_fn(cfg, model, _torch(batch), last_only=False)
        _, n_prefix = lm.forward(cfg, model, _torch(batch))
        last = lm.build_model(cfg).forward(model, _torch(batch))
    assert n_prefix == jn_prefix == (cfg.num_prefix if prefix else 0)
    assert got.shape == (2, n_prefix + 16, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(last, got[:, -1:])


def _run_jax(jcfg, tree, batch, cap, feed):
    params = jax.tree.map(jnp.asarray, tree)
    logits, cache = jax_lm.prefill(jcfg, params, batch, capacity=cap, impl="ref")
    out = [(logits, cache)]
    for tok in feed:
        logits, cache = jax_lm.decode_step(jcfg, params, cache, jnp.asarray(tok), impl="ref")
        out.append((logits, cache))
    return out


def _copy(cache):
    return [{k: (v.clone() if isinstance(v, torch.Tensor) else
                 {n: t.clone() for n, t in v.items()}) for k, v in c.items()}
            for c in cache["layers"]]


def _run_port(cfg, model, batch, cap, feed, impl=None):
    logits, cache = lm.prefill(cfg, model, _torch(batch), capacity=cap, impl=impl)
    out = [(logits.clone(), _copy(cache))]
    for tok in feed:
        logits, cache = lm.decode_step(cfg, model, cache, torch.from_numpy(tok).long(), impl=impl)
        out.append((logits.clone(), _copy(cache)))
    return out, cache


def _feed(cfg, n=4):
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", [None, "ref"])
def test_prefill_and_decode_match_jax_ref(case, dtype, impl):
    """Logits at the prefill and at each of 4 decode steps; in float32 every
    self and cross cache; and the cross caches bitwise those the prefill
    wrote, after every decode step."""
    jcfg, cfg, tree, prefix = _setup(case, dtype)
    batch = _batch(cfg, prefix)
    feed = _feed(cfg)
    cap = (cfg.num_prefix if prefix else 0) + 16 + len(feed) + 2
    want = _run_jax(jcfg, tree, batch, cap, feed)
    got, cache = _run_port(cfg, bridge.from_jax(cfg, tree, device="cpu"), batch, cap, feed,
                           impl)
    tol = TOL[dtype]
    for (jl, jc), (tl, tc) in zip(want, got):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=tol)
        for i, c in enumerate(tc):
            jlayer = jax.tree.map(lambda leaf: leaf[i], jc["layers"]["pos0"])
            assert c.keys() == jlayer.keys()
            if cfg.encdec:
                assert c["cross_k"].shape == (2, FRAMES, cfg.attn.n_kv_heads, cfg.attn.head_dim)
                assert torch.equal(c["cross_k"], got[0][1][i]["cross_k"])
                assert torch.equal(c["cross_v"], got[0][1][i]["cross_v"])
            if dtype == "float32":   # bf16 caches differ by whole bf16 steps
                flat = bridge.flat_tree(c)
                for key, value in flat.items():
                    np.testing.assert_allclose(_np(value), _np(bridge.flat_tree(jlayer)[key]),
                                               atol=tol, rtol=tol, err_msg=key)
    assert int(cache["pos"]) == int(want[-1][1]["pos"])
    if cfg.encdec:
        assert cache["cross_len"].dtype == torch.int32 and int(cache["cross_len"]) == FRAMES


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_then_decode_matches_the_full_forward(case):
    """float32: the logits of one decode step after a prefill of S - 1
    tokens are those of the full forward over S tokens at its last
    position (``tests/test_models_smoke.py``'s check)."""
    _, cfg, tree, prefix = _setup(case)
    model = bridge.from_jax(cfg, tree, device="cpu")
    batch = _torch(_batch(cfg, prefix, s=24))
    with torch.no_grad():
        full = lm.logits_fn(cfg, model, batch)
        pre = dict(batch, tokens=batch["tokens"][:, :-1])
        _, cache = lm.prefill(cfg, model, pre, capacity=128)
        step, _ = lm.decode_step(cfg, model, cache, batch["tokens"][:, -1:])
    torch.testing.assert_close(step, full, atol=1e-4, rtol=1e-4)


# -- the loss, its gradients and the train step ---------------------------------
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_jax(case, compute_dtype):
    """The prefix rows are left out of the loss: labels (B, S) against the
    last S of the P + S hidden states."""
    jcfg, cfg, tree, prefix = _setup(case, compute_dtype)
    batch = _batch(cfg, prefix)
    (want_loss, _), jgrads = jax.value_and_grad(
        lambda p: jax_lm.loss_fn(jcfg, p, batch, impl="ref"), has_aux=True)(tree)
    want = bridge._flat_jax(cfg, jax.tree.map(np.asarray, jgrads))
    model = bridge.from_jax(cfg, tree, device="cpu", param_dtype=torch.float32)
    loss, _ = lm.build_model(cfg).loss_fn(model, _torch(batch))
    loss.backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    if compute_dtype == "float32":
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
        for k, g in got.items():
            w = torch.from_numpy(np.asarray(want[k], dtype=np.float32))
            torch.testing.assert_close(g, w, atol=1e-4 * float(w.abs().max()) + 1e-12,
                                       rtol=0, msg=k)
    else:
        assert float(loss) == pytest.approx(float(want_loss), rel=2e-3)
        for k, g in got.items():
            w = torch.from_numpy(np.asarray(want[k], dtype=np.float32))
            assert float((g - w).norm() / (w.norm() + 1e-12)) < 0.2, k
    if cfg.encdec:        # the encoder is reached through every cross-attention
        assert float(got["enc_layers.0.mixer.wq"].abs().max()) > 0
        assert float(got["enc_norm"].abs().max()) > 0


@pytest.mark.parametrize("case", ["seamless", "internvl-prefix"])
def test_two_train_steps_match_jax(case):
    """Two `make_train_step` steps, accum 2, AdamW on the cosine schedule,
    against JAX's unjitted ``make_train_step(cfg, impl="ref")``: every batch
    leaf, frames and prefix embeddings too, comes as (accum, B / accum,
    ...)."""
    jcfg, cfg, tree, prefix = _setup(case, grad_accum=2)
    kw = dict(lr=1e-3, warmup=1, total_steps=10)
    _, jopt, jstep = jax_make_train_step(jcfg, impl="ref", **kw)
    opt, step_fn = make_train_step(cfg, **kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    model = bridge.from_jax(cfg, tree, device="cpu", param_dtype=torch.float32)
    state = opt.init(dict(model.named_parameters()))
    for step in range(2):
        batch = _batch(cfg, prefix, b=2, seed=10 + step, lead=(2,))
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(step, jnp.int32), batch)
        m = step_fn(model, state, step, _torch(batch))
        assert m["step"] == step + 1
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    want = bridge._flat_jax(cfg, jax.tree.map(np.asarray, jparams))
    for k, p in model.named_parameters():
        w = torch.from_numpy(np.asarray(want[k], dtype=np.float32))
        torch.testing.assert_close(p.detach(), w, atol=1e-5 * float(w.abs().max()), rtol=0,
                                   msg=k)


# -- cross-attention decode through ops.decode_attention ------------------------
@pytest.mark.parametrize("case", ["seamless", "seamless-gqa1"])
@pytest.mark.parametrize("se", [13, 1])
def test_cross_attention_decode_at_a_ragged_length_matches_jax(case, se):
    jcfg, cfg, tree, _ = _setup(case)
    model = bridge.from_jax(cfg, tree, device="cpu")
    cross = model.layers[1].cross
    rng = np.random.default_rng(se)
    a = cfg.attn
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    k, v = (rng.normal(size=(3, se, a.n_kv_heads, a.head_dim)).astype(np.float32)
            for _ in range(2))
    p = jax.tree.map(lambda leaf: leaf[1], tree["layers"]["pos0"]["cross"])
    want = jax_blocks.cross_attn_decode(p, jcfg, jnp.asarray(x), (jnp.asarray(k),
                                                                  jnp.asarray(v)), impl="ref")
    tx, tk, tv = (torch.from_numpy(t) for t in (x, k, v))
    length = torch.tensor(se, dtype=torch.int32)
    for impl in (None, "ref"):
        with torch.no_grad():
            got = cross.decode(tx, tk, tv, length, impl=impl)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    q = rng.normal(size=(3, a.n_heads, a.head_dim)).astype(np.float32)
    want = jax_ops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), se,
                                    impl="ref")
    for impl in (None, "ref"):
        got = ops.decode_attention(torch.from_numpy(q), tk, tv, length, impl=impl)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_decode_attention_op_refuses_a_host_length_with_card_tensors():
    """On the card the length must be a device tensor: an int raises
    before any launch; no plain-version fallback."""
    q = torch.zeros(1, 4, 16, device="meta")
    kc = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises((TypeError, ValueError)):
        ops.decode_attention(q, kc, kc, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q, kc, kc, torch.tensor(8, dtype=torch.int32))


# -- what serves these families -------------------------------------------------
def test_server_refuses_an_encoder_decoder():
    with pytest.raises(ValueError, match="frames"):
        LMServer(get_config("seamless-m4t-medium-smoke"), device="cpu")


def test_pipelines_keep_refusing_the_encoder_decoder():
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.graphs import lm_graph
    cfg = get_config("seamless-m4t-medium-smoke")
    shape = ShapeCfg("d", 64, 4, "decode")
    plan = planner.plan(cfg, shape, chips=8, max_tp=1)
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=1)
    with pytest.raises(ValueError, match="enc-dec"):
        DecodePipeline(cfg, stg, plan, device="cpu")


def test_server_serves_the_prefix_model_text_only_as_jax():
    """internvl2-26b-smoke through both servers, float32, requests of tokens
    only (the prefix is left out, as the JAX server leaves it); tokens
    agree up to the first near-tie (``test_torch_server.py``'s rule)."""
    jcfg = dataclasses.replace(jax_get_config("internvl2-26b-smoke"), compute_dtype="float32")
    cfg = dataclasses.replace(get_config("internvl2-26b-smoke"), compute_dtype="float32")
    jax_srv = JaxServer(jcfg, max_batch=2, seed=0, impl="ref")
    model = bridge.from_jax(cfg, jax.tree.map(np.array, jax_srv.params), device="cpu")
    srv = LMServer(cfg, max_batch=2, params=model, device="cpu")
    reqs = _requests(cfg, 2)
    want = jax_srv.serve([JaxRequest(u, p, m) for u, p, m in reqs])
    got = srv.serve([Request(u, p, m) for u, p, m in reqs])
    jt = [c.tokens for c in want]
    margins = _margins(cfg, model, reqs, jt)
    for i, c in enumerate(got):
        diff = [t for t, (a, b) in enumerate(zip(c.tokens, jt[i])) if a != b]
        if diff:
            assert margins[i][diff[0]] < TIE, (c.uid, diff[0], margins[i][diff[0]])
        else:
            assert len(c.tokens) == len(jt[i])
