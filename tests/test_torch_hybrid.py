"""The port's hybrid family (``jamba-1.5-large-398b``) against the JAX package's.

Config: ``jamba-1.5-large-398b-smoke``, the ``reduced()`` form: 16 layers
(two periods of jamba's 8: attention then seven Mamba2 mixers, an MoE
after every second layer), d_model 64, 16 SSM heads of 8 (N 16), 4
experts top-2, 4 heads on 2.  Weights come from JAX ``init_params`` through
``bridge.from_jax``, each router at its fan-in scale (``D ** -0.5``) and
each norm random around 1, as ``tests/test_torch_moe.py`` draws them;
numpy inputs come from a seed.  The JAX side runs ``impl="ref"``.

Tolerances (float32 throughout):
  * logits and every layer's cache (KV, conv tail, SSM state): 1e-3
    absolute plus 1e-4 relative.  ``test_torch_moe.py`` holds two to four
    layers to 1e-4; this stack is 16 deep, and a change of 1e-7 relative
    (float32's rounding) to the embedding table alone moves its logits by
    up to 3.4e-4 (``test_logit_spread_of_a_float32_rounding``), which is
    the size of the difference seen between the two frameworks;
  * the loss: 1e-5 relative; each gradient leaf: 5e-3 of the leaf's
    largest entry (the same 1e-7 change of the embedding table moves a
    leaf's gradient by up to 1.5e-3 of its largest entry, as much as the
    two frameworks differ);
  * one Adafactor step: each parameter within 1e-5 of its largest entry
    (``tests/test_torch_configs.py``'s train-step tolerance), but where
    the first step's update, g / |g| for a leaf with a full second
    moment, takes the sign of a gradient entry within the gradient
    tolerance of 0 (at most 1e-4 of the parameters);
  * greedy tokens: equal up to the first step whose top-2 logit margin is
    under the logit tolerance (``tests/test_torch_server.py``'s rule);
  * the pipelines: bitwise their own oracles.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import lm as jax_lm
from repro.runtime.server import LMServer as JaxServer
from repro.runtime.server import Request as JaxRequest
from repro_torch import bridge
from repro_torch.configs import first_layers, get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.core import planner
from repro_torch.core.stg import Selection
from repro_torch.graphs import lm_graph
from repro_torch.launch import serve
from repro_torch.launch.steps import make_train_step
from repro_torch.models import blocks, lm
from repro_torch.optim.api import jax_leaf_groups
from repro_torch.runtime.pipeline import DecodePipeline, LMPipeline, one_f_one_b
from repro_torch.runtime.server import LMServer, Request, _bucket

JAMBA = "jamba-1.5-large-398b"
LOGIT_ATOL, LOGIT_RTOL = 1e-3, 1e-4
GRAD_TOL = 5e-3


def _pair(**kw):
    """(JAX config, port config): the smoke form, in float32 unless ``kw``."""
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(jax_get_config(JAMBA + "-smoke"), **kw),
            dataclasses.replace(get_config(JAMBA + "-smoke"), **kw))


@functools.lru_cache(maxsize=None)
def _tree():
    """JAX `init_params` of the smoke form, routers at fan-in scale and
    norms random around 1, as numpy."""
    jcfg, _ = _pair()
    tree = jax.tree.map(np.array, jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for pos in tree["layers"].values():
        for part in pos.values():
            if "router" in part:
                part["router"] = (rng.normal(size=part["router"].shape)
                                  * jcfg.d_model ** -0.5).astype(np.float32)
            part["norm"] = (1 + 0.1 * rng.normal(size=part["norm"].shape)).astype(np.float32)
    return tree


def _prompts(cfg, lens=(24, 13), steps=4):
    """Right-aligned prompts padded with token 0, as the server batches
    them, and ``steps`` tokens to feed."""
    rng = np.random.default_rng(2)
    toks = np.zeros((len(lens), max(lens)), np.int64)
    for i, n in enumerate(lens):
        toks[i, max(lens) - n:] = rng.integers(2, cfg.vocab, n)
    feed = [rng.integers(2, cfg.vocab, (len(lens), 1)).astype(np.int64) for _ in range(steps)]
    return toks, feed


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL, err_msg=err_msg)


def test_prefill_and_decode_match_jax():
    """Logits of a prefill over padded prompts and 4 decode steps, and
    every layer's cache after them, against JAX ``impl="ref"``."""
    jcfg, cfg = _pair()
    tree = _tree()
    model = bridge.from_jax(cfg, tree, device="cpu")
    toks, feed = _prompts(cfg)
    cap = toks.shape[1] + len(feed)
    params = jax.tree.map(jnp.asarray, tree)
    jl, jc = jax_lm.prefill(jcfg, params, {"tokens": jnp.asarray(toks)}, capacity=cap,
                            impl="ref")
    with torch.no_grad():
        tl, tc = lm.prefill(cfg, model, {"tokens": torch.from_numpy(toks)}, capacity=cap)
        steps = [(np.asarray(jl), tl.clone())]
        for tok in feed:
            jl, jc = jax_lm.decode_step(jcfg, params, jc, jnp.asarray(tok), impl="ref")
            tl, tc = lm.decode_step(cfg, model, tc, torch.from_numpy(tok))
            steps.append((np.asarray(jl), tl.clone()))
    for i, (want, got) in enumerate(steps):
        _close(got.numpy(), want, f"step {i}")
    n = len(cfg.block_pattern)
    kinds = set()
    for i, c in enumerate(tc["layers"]):
        kinds.add(tuple(sorted(c)))
        for leaf, value in c.items():
            _close(value.numpy(), np.asarray(jc["layers"][f"pos{i % n}"][leaf][i // n]),
                   f"layer {i} {leaf}")
    assert kinds == {("k", "v"), ("conv", "ssm")}
    assert int(tc["pos"]) == toks.shape[1] + len(feed)


def test_logit_spread_of_a_float32_rounding():
    """What a change of float32 rounding alone does to this stack's
    logits: the embedding table scaled by 1 + 1e-7 noise moves them by
    more than 1e-4 (so the 1e-4 of shallower stacks cannot hold here) and
    less than the stated tolerance."""
    _, cfg = _pair()
    toks, feed = _prompts(cfg)
    models = [bridge.from_jax(cfg, _tree(), device="cpu") for _ in range(2)]
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        models[1].embed.mul_(1 + 1e-7 * torch.randn(models[1].embed.shape, generator=g))
        outs = []
        for m in models:
            lg, cache = lm.prefill(cfg, m, {"tokens": torch.from_numpy(toks)},
                                   capacity=toks.shape[1] + len(feed))
            out = [lg.clone()]
            for tok in feed:
                lg, cache = lm.decode_step(cfg, m, cache, torch.from_numpy(tok))
                out.append(lg.clone())
            outs.append(torch.stack(out))
    spread = float((outs[0] - outs[1]).abs().max())
    assert 1e-4 < spread < LOGIT_ATOL, spread


def test_bridge_maps_mamba_mixers_and_experts_at_every_period():
    """Period 1, position 1 (a Mamba2 mixer before an MoE) lands in layer
    9; position 0 (attention before a dense MLP) in layer 8."""
    _, cfg = _pair()
    tree = _tree()
    model = bridge.from_jax(cfg, tree, device="cpu")
    p = dict(model.named_parameters())
    pos1, pos0 = tree["layers"]["pos1"], tree["layers"]["pos0"]
    for name, want in (("layers.9.mixer.w_xz", pos1["mixer"]["w_xz"][1]),
                       ("layers.9.mixer.a_log", pos1["mixer"]["a_log"][1]),
                       ("layers.9.mlp.router", pos1["mlp"]["router"][1]),
                       ("layers.9.mlp.experts.w_down", pos1["mlp"]["experts"]["w_down"][1]),
                       ("layers.8.mixer.wq", pos0["mixer"]["wq"][1]),
                       ("layers.8.mlp.w_gate", pos0["mlp"]["w_gate"][1])):
        np.testing.assert_array_equal(p[name].detach().numpy(), want, err_msg=name)
    assert isinstance(model.layers[9].mixer, blocks.Mamba)
    assert isinstance(model.layers[9].mlp, blocks.MoE)
    assert p["layers.9.mlp.experts.w_down"].shape == (4, 64, 64)


def _requests(cfg, n=4, seed=3, max_new=6):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(2, cfg.vocab, rng.integers(3, 20)).tolist(), max_new)
            for i in range(n)]


def _margins(cfg, model, reqs, jax_tokens):
    """Top-2 logit margin at each step of each request of one round,
    replaying the JAX tokens through the port model as the server batches
    them."""
    bucket = _bucket(max(len(p) for _, p, _ in reqs))
    toks = np.zeros((len(reqs), bucket), np.int64)
    for i, (_, p, _) in enumerate(reqs):
        toks[i, bucket - len(p):] = p
    cap = bucket + max(m for _, _, m in reqs)
    out = []
    with torch.no_grad():
        logits, cache = lm.prefill(cfg, model, {"tokens": torch.from_numpy(toks)}, capacity=cap)
        for t in range(max(len(jt) for jt in jax_tokens)):
            top2 = torch.topk(logits[:, -1].float(), 2, dim=-1).values
            out.append((top2[:, 0] - top2[:, 1]).tolist())
            feed = [[jt[t] if t < len(jt) else 0] for jt in jax_tokens]
            logits, cache = lm.decode_step(cfg, model, cache, torch.tensor(feed))
    return np.array(out).T


def test_server_completions_match_jax_server():
    """`LMServer(device="cpu")` against the JAX `LMServer(impl="ref")` on
    the same weights: greedy tokens equal up to the first near-tie."""
    jcfg, cfg = _pair()
    jax_srv = JaxServer(jcfg, max_batch=2, params=jax.tree.map(jnp.asarray, _tree()),
                        impl="ref")
    model = bridge.from_jax(cfg, _tree(), device="cpu")
    srv = LMServer(cfg, max_batch=2, params=model, device="cpu")
    reqs = _requests(cfg)
    want = jax_srv.serve([JaxRequest(u, p, m) for u, p, m in reqs])
    got = srv.serve([Request(u, p, m) for u, p, m in reqs])
    assert [c.uid for c in got] == [c.uid for c in want]
    agreed = 0
    for lo in range(0, len(reqs), 2):
        jt = [c.tokens for c in want[lo:lo + 2]]
        margins = _margins(cfg, model, reqs[lo:lo + 2], jt)
        for i, c in enumerate(got[lo:lo + 2]):
            diff = [t for t, (a, b) in enumerate(zip(c.tokens, jt[i])) if a != b]
            if diff:
                assert margins[i][diff[0]] < LOGIT_ATOL, (c.uid, diff[0], margins[i][diff[0]])
                agreed += diff[0]
            else:
                assert len(c.tokens) == len(jt[i])
                agreed += len(c.tokens)
    assert agreed >= len(reqs) * 3


def _batch(cfg, b=2, s=40, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (b, s)).astype(np.int32) for k in ("tokens", "labels")}


def test_loss_and_every_gradient_match_jax():
    """`loss_fn` and every leaf's gradient (attention, Mamba2, router,
    experts, dense MLP) against ``jax.value_and_grad(lm.loss_fn,
    impl="ref")``, at the default capacity over 40 tokens (tokens drop)."""
    jcfg, cfg = _pair()
    tree = _tree()
    batch = _batch(cfg)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_lm.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
                                 impl="ref"), has_aux=True)(jax.tree.map(jnp.asarray, tree))
    model = bridge.from_jax(cfg, tree, device="cpu", param_dtype=torch.float32)
    loss, _ = lm.loss_fn(cfg, model, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = bridge._flat_jax(cfg, jax.tree.map(np.asarray, jgrads))
    names = {k for k, _ in model.named_parameters()}
    assert {"layers.1.mixer.a_log", "layers.9.mlp.router", "layers.15.mlp.experts.w_gate",
            "layers.8.mixer.wk", "layers.2.mlp.w_down"} <= names
    for k, p in model.named_parameters():
        w = np.asarray(want[k], np.float32)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max() + 1e-7, err_msg=k)


def test_adafactor_train_step_matches_jax():
    """One `make_train_step` update (Adafactor, the config's optimizer,
    its clip over the leaves stacked over both periods) against JAX's
    unjitted `make_train_step` from the same float32 masters and batch."""
    jcfg, cfg = _pair()
    assert cfg.optimizer == "adafactor"
    tree = _tree()
    kw = dict(lr=1e-2, warmup=0, total_steps=10)
    _, jopt, jstep = jax_make_train_step(jcfg, impl="ref", **kw)
    opt, step_fn = make_train_step(cfg, **kw)
    batch = _batch(cfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    jparams, _, jm = jstep(jparams, jopt.init(jparams), jnp.asarray(0, jnp.int32),
                           {k: jnp.asarray(v[None]) for k, v in batch.items()})
    model = bridge.from_jax(cfg, tree, device="cpu", param_dtype=torch.float32)
    m = step_fn(model, opt.init(dict(model.named_parameters())), 0,
                {k: torch.from_numpy(v[None]).long() for k, v in batch.items()})
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    want = bridge._flat_jax(cfg, jax.tree.map(np.asarray, jparams))
    before = bridge._flat_jax(cfg, tree)
    flips = 0
    for k, p in model.named_parameters():
        w, got = np.asarray(want[k], np.float32), p.detach().numpy()
        assert not np.array_equal(w, before[k]), k
        off = np.abs(got - w) > 1e-5 * np.abs(w).max() + 1e-12
        # the first step's update of a leaf with a full second moment is
        # g / |g|: where g is float32 noise (within the gradient tolerance
        # of 0) its sign, and so the update, may differ
        g = p.grad.numpy()
        assert (np.abs(g[off]) <= GRAD_TOL * np.abs(g).max()).all(), k
        flips += int(off.sum())
    assert flips <= 1e-4 * sum(p.numel() for p in model.parameters()), flips


def test_leaf_groups_follow_the_hybrid_stacking():
    """Each position of the 8-layer pattern is one JAX leaf over both
    periods: layers i and i + 8."""
    _, cfg = _pair()
    names = [k for k, _ in lm.LM(cfg, device="meta").named_parameters()]
    groups = jax_leaf_groups(cfg, names)
    by_first = {g[0]: g for g in groups}
    assert by_first["layers.1.mlp.experts.w_up"] == ["layers.1.mlp.experts.w_up",
                                                     "layers.9.mlp.experts.w_up"]
    assert by_first["layers.3.mixer.a_log"] == ["layers.3.mixer.a_log", "layers.11.mixer.a_log"]
    assert by_first["layers.0.mixer.wq"] == ["layers.0.mixer.wq", "layers.8.mixer.wq"]
    assert sorted(sum(groups, [])) == sorted(names)
    assert all(len(g) == 2 for g in groups if g[0].startswith("layers."))


def test_lm_pipeline_1f1b_is_the_oracle():
    """1F1B over the smoke form's stages (attention, Mamba2 and MoE layers
    among them): gradients and losses bitwise the sequential oracle's, the
    serve bitwise `reference()`'s."""
    cfg = get_config(JAMBA + "-smoke")
    shape = ShapeCfg("hybrid_pipe", 16, 8, "train")
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=4)
    pipe = LMPipeline(cfg, stg, Selection.smallest(stg), device="cpu", layers_per_stage=4)
    rng = np.random.default_rng(0)
    mbs = [rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32) for _ in range(4)]

    def loss(lg):
        return torch.mean(lg.float() ** 2)

    try:
        res = pipe.run(mbs, train=True, loss_fn=loss, schedule=one_f_one_b(pipe.n_stages, 4))
        grads, losses = pipe.sequential(mbs, loss_fn=loss)
        served, ref = pipe.run(mbs), pipe.reference(mbs)
    finally:
        pipe.close()
    assert losses == res.losses
    for name, tree in grads.items():
        got, want = bridge.flat_tree(res.grads[name]), bridge.flat_tree(tree)
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), (name, k)
    leaves = {k for t in grads.values() for k in bridge.flat_tree(t)}
    assert any("router" in k for k in leaves) and any("a_log" in k for k in leaves)
    assert any(k.endswith("mix.wq") for k in leaves)
    for a, b in zip(served.outputs, ref):
        assert torch.equal(a, b)


def test_decode_pipeline_serves_as_the_single_device_server():
    """The planner's decode pipeline over the smoke form (one period a
    stage: attention, Mamba2 and MoE caches in each) gives the
    single-device server's tokens."""
    cfg = get_config(JAMBA + "-smoke")
    shape = ShapeCfg("hybrid_decode", 128, 16, "decode")
    plan = planner.plan(cfg, shape, chips=8, max_tp=4)
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=4)
    model = lm.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))

    def requests():
        rng = np.random.default_rng(1)
        return [Request(uid=i, prompt=rng.integers(2, cfg.vocab, n).tolist(), max_new=6)
                for i, n in enumerate([20, 9, 33, 14, 7, 25])]
    want = LMServer(cfg, max_batch=4, params=model, device="cpu").serve(requests())
    pipe = DecodePipeline(cfg, stg, plan, devices=["cpu"], params=model, periods_per_stage=1)
    try:
        got = LMServer(cfg, max_batch=4, device="cpu", pipeline=pipe).serve(requests())
        assert pipe.compile_stats.late == 0
        assert len([n for n in pipe.stage_names if n.startswith("blocks")]) == cfg.n_periods
    finally:
        pipe.close()
    assert [o.tokens for o in got] == [o.tokens for o in want]


def test_serve_cli_runs_jamba():
    srv, outs = serve.main(["--arch", JAMBA, "--reduced", "--device", "cpu", "--requests", "3",
                            "--max-new", "4", "--prompt-len", "20", "--seed", "1"])
    assert len(outs) == 3 and all(1 <= len(o.tokens) <= 4 for o in outs)
    kinds = [(type(layer.mixer).__name__, type(layer.mlp).__name__)
             for layer in srv.params.layers]
    assert kinds[:4] == [("Attention", "MLP"), ("Mamba", "MoE"), ("Mamba", "MLP"),
                         ("Mamba", "MoE")]


@pytest.mark.parametrize("n_layers", [2, 4])
def test_cut_configs_keep_jamba_layer_order(n_layers):
    """The cuts the card serves: the first 2 and 4 layers of jamba at full
    width, in jamba's order, build (on the meta device: no storage) with
    the published widths."""
    full = get_config(JAMBA)
    cut = first_layers(full, n_layers)
    assert cut.block_pattern == full.block_pattern[:n_layers] and cut.n_layers == n_layers
    assert dataclasses.replace(cut, n_layers=full.n_layers,
                               block_pattern=full.block_pattern) == full
    model = lm.build_model(cut)
    params = lm.LM(cut, device="meta")
    kinds = [(layer.kind, "moe" if layer.moe else "dense") for layer in params.layers]
    assert kinds == [("attn", "dense"), ("mamba", "moe"), ("mamba", "dense"),
                     ("mamba", "moe")][:n_layers]
    assert model.cfg is cut
    m = params.layers[1].mixer
    assert m.w_xz.shape == (8192, 32768) and m.a_log.shape == (256,)
    assert params.layers[1].mlp.experts.w_up.shape == (16, 8192, 24576)
    n = sum(p.numel() for p in params.parameters())
    assert n == {2: 11_899_495_168, 4: 22_981_175_552}[n_layers]


def test_first_layers_keeps_whole_periods():
    full = get_config(JAMBA)
    assert first_layers(full, 16) == dataclasses.replace(full, n_layers=16)
    assert first_layers(get_config("qwen2.5-3b"), 2).block_pattern == (("attn", "dense"),)
    with pytest.raises(ValueError, match="whole periods"):
        first_layers(full, 12)


def test_moe_routing_keeps_each_expert_within_its_capacity():
    """`MoE.routing` over the hybrid's MoE: each round's gate is the
    probability left at its expert, a token's two experts differ, and no
    expert keeps more than its capacity of a row's tokens over both rounds.
    A row of one repeated token sends every token to the same two experts,
    which keep the first ``capacity`` in sequence order and drop the rest."""
    _, cfg = _pair()
    layer = blocks.MoE(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    cap = layer.capacity(40)
    for x in (torch.randn(2, 40, cfg.d_model, generator=g),
              torch.randn(2, 1, cfg.d_model, generator=g).expand(2, 40, -1).contiguous()):
        r = layer.routing(x)
        experts, kept = r["experts"], r["kept"]                   # (k, B, S)
        assert experts.shape == kept.shape == (cfg.moe.top_k, 2, 40)
        assert bool((experts[0] != experts[1]).all())
        probs = torch.softmax(r["logits"], dim=-1)
        gate = layer._rounds(probs)[0][1]
        assert torch.equal(gate, probs.gather(-1, experts[0][..., None])[..., 0])
        onehot = torch.nn.functional.one_hot(experts, cfg.moe.n_experts) * kept[..., None]
        assert int(onehot.sum(dim=(0, 2)).max()) <= cap
    assert cap < 40
    want = torch.arange(40) < cap
    assert all(torch.equal(kept[k, b], want) for k in range(2) for b in range(2))
