"""The port's MoE (`blocks.MoE` and the MoE decoders) against the JAX package's.

Configs: ``llama4-scout-17b-a16e`` and ``llama4-maverick-400b-a17b``
``reduced()`` (4 experts, top-1, a shared expert; maverick alternates a
dense and an MoE layer), and a top-2 variant of scout's.  The JAX side
runs its GShard einsum path (`blocks.moe_forward`), its sorted path's
one-device branch and its ``lm`` functions with ``impl="ref"``; numpy
inputs come from a seed.  The router is drawn at its fan-in scale
(``D ** -0.5``) rather than the init's 0.02, so that routing is
decisive: at 0.02 the probabilities are all within a few percent of
1/E.  Each input's smallest top-2 probability gap is asserted above
``GAP`` (1e-4), so no expert choice below rests on float32 noise.

Tolerances:
  * float32: 1e-5 (outputs of one sublayer: the expert products sum
    float32 terms in another order in each framework); 1e-4 on the
    logits of a two-layer model and 1e-4 of a leaf's largest entry on its
    gradient, as ``tests/test_torch_model.py`` and
    ``tests/test_torch_train.py`` hold the dense decoders;
  * bf16: 4 bf16 steps at the output's magnitude (each of the expert
    products, the gate and the shared expert rounds once to bf16, the two
    frameworks from float32 sums in another order);
  * expert choices and kept masks: equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.models import blocks as jax_blocks
from repro.models import lm as jax_lm
from repro.models.common import KeyGen, rmsnorm as jax_rmsnorm
from repro.optim import adafactor as jax_adafactor
from repro.optim import cosine_schedule as jax_cosine
from repro.runtime.pipeline.jax_pipe import build_lm_stages as jax_build_lm_stages
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.core.stg import Selection
from repro_torch.graphs import lm_graph
from repro_torch.launch import serve
from repro_torch.models import blocks, lm
from repro_torch.optim import cosine_schedule, get_optimizer
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.api import jax_leaf_groups
from repro_torch.runtime.pipeline import LMPipeline, one_f_one_b

SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
# (name, top_k): the two configs' reduced forms and a top-2 scout
VARIANTS = {"scout": (SCOUT, 1), "maverick": (MAVERICK, 1), "scout-top2": (SCOUT, 2)}
GAP = 1e-4
F32, BF16_STEPS = 1e-5, 4


def _pair(name, top_k=1, capacity_factor=1.25, **kw):
    """(JAX config, port config): ``name``'s reduced form at ``top_k``."""
    out = []
    for get in (jax_get_config, get_config):
        cfg = get(name).reduced()
        moe = dataclasses.replace(cfg.moe, top_k=top_k, capacity_factor=capacity_factor)
        out.append(dataclasses.replace(cfg, moe=moe, **kw))
    return tuple(out)


def _moe_tree(jcfg, seed=0):
    """A JAX `init_moe` tree, its router at fan-in scale and its norm
    random around 1, as numpy."""
    tree = jax.tree.map(np.array, jax_blocks.init_moe(KeyGen(jax.random.PRNGKey(seed)),
                                                      jcfg, "t"))
    rng = np.random.default_rng(seed + 1)
    tree["router"] = (rng.normal(size=tree["router"].shape) * jcfg.d_model ** -0.5
                      ).astype(np.float32)
    tree["norm"] = (1 + 0.1 * rng.normal(size=tree["norm"].shape)).astype(np.float32)
    return tree


def _port_moe(cfg, tree, param_dtype=None):
    layer = blocks.MoE(cfg, device="cpu", param_dtype=param_dtype)
    dst = dict(layer.named_parameters())
    src = bridge.flat_tree(tree)
    assert src.keys() == dst.keys()
    with torch.no_grad():
        for k, v in src.items():
            dst[k].copy_(torch.from_numpy(np.asarray(v, np.float32)))
    return layer


def _inputs(cfg, B=3, S=32, seed=2, pads=(0, 5, 17)):
    """x (B, S, D) float32, row b led by ``pads[b]`` copies of one vector:
    the hidden state that the server's right-aligned prompts, padded with
    token 0, give every pad position."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pad = rng.normal(size=cfg.d_model).astype(np.float32)
    for b, n in enumerate(pads[:B]):
        x[b, :n] = pad
    return x


def _jax_probs(jcfg, tree, x):
    p = jax.tree.map(jnp.asarray, tree)
    h = jax_rmsnorm(jnp.asarray(x), p["norm"], jcfg.norm_eps)
    return np.asarray(jax.nn.softmax(h.astype(jnp.float32) @ p["router"], axis=-1))


def _einsum_routing(jcfg, probs):
    """The einsum path's expert choices and kept masks, round by round, as
    `moe_forward` computes them, on the JAX package's probabilities."""
    e = jcfg.moe
    B, S, E = probs.shape
    cap = max(1, int(S * e.capacity_factor * e.top_k / E))
    occupancy = np.zeros((B, E), np.int64)
    remaining = probs.copy()
    experts, kept = [], []
    for _ in range(e.top_k):
        idx = remaining.argmax(-1)
        onehot = np.eye(E, dtype=np.int64)[idx]
        pos = np.cumsum(onehot, axis=1) - onehot + occupancy[:, None]
        keep = (pos * onehot).sum(-1) < cap
        occupancy += (onehot * keep[..., None]).sum(1)
        remaining[np.arange(B)[:, None], np.arange(S)[None], idx] = 0
        experts.append(idx)
        kept.append(keep)
    return np.stack(experts), np.stack(kept)


def _assert_decisive(probs, top_k):
    """Every choice of the ``top_k`` rounds beats the next probability by
    at least GAP."""
    top = np.sort(probs, axis=-1)[..., ::-1]
    gap = float((top[..., :top_k] - top[..., 1:top_k + 1]).min())
    assert gap >= GAP, f"a top-{top_k + 1} probability gap of {gap} < {GAP} in this input"


def _bf16_tol(want):
    return BF16_STEPS * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


# -- the sublayer ------------------------------------------------------------
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.26])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_moe_forward(variant, cf):
    """`MoE.forward` against JAX `moe_forward` in float32, with no drops
    (8), the default capacity (1.25) and heavy drops (0.26); the expert
    choices and kept masks equal the einsum path's."""
    name, k = VARIANTS[variant]
    jcfg, cfg = _pair(name, k, capacity_factor=cf, compute_dtype="float32")
    tree = _moe_tree(jcfg)
    x = _inputs(cfg)
    probs = _jax_probs(jcfg, tree, x)
    _assert_decisive(probs, k)
    want = np.asarray(jax_blocks.moe_forward(jax.tree.map(jnp.asarray, tree), jcfg,
                                             jnp.asarray(x)))
    layer = _port_moe(cfg, tree)
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
        route = layer.routing(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32, atol=F32)
    experts, kept = _einsum_routing(jcfg, probs)
    np.testing.assert_array_equal(route["experts"].numpy(), experts)
    np.testing.assert_array_equal(route["kept"].numpy(), kept)
    if cf == 0.26:
        assert not kept.all()          # the case drops tokens
    if cf == 8.0:
        assert kept.all()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_moe_forward_in_bf16(variant):
    """bf16 compute (float32 router and norm, bf16 weights and
    activations) at the default capacity: within 4 bf16 steps at the
    output's magnitude, the same expert choices."""
    name, k = VARIANTS[variant]
    jcfg, cfg = _pair(name, k, compute_dtype="bfloat16")
    tree = _moe_tree(jcfg)
    x = _inputs(cfg)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    probs = _jax_probs(jcfg, tree, xb)
    _assert_decisive(probs, k)
    want = np.asarray(jax_blocks.moe_forward(jax.tree.map(jnp.asarray, tree), jcfg, xb)
                      .astype(jnp.float32))
    layer = _port_moe(cfg, tree)
    assert layer.router.dtype == torch.float32 and layer.experts.w_up.dtype == torch.bfloat16
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        got = layer(xt)
        route = layer.routing(xt)
    assert got.dtype == torch.bfloat16
    tol = _bf16_tol(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    np.testing.assert_array_equal(route["experts"].numpy(), _einsum_routing(jcfg, probs)[0])


@pytest.mark.parametrize("cf", [1.25, 0.26])
@pytest.mark.parametrize("variant", ["scout", "scout-top2"])
def test_forward_sorted_matches_the_sorted_path(variant, cf):
    """`MoE.forward_sorted` (and `forward` under ``set_moe_impl("sorted")``)
    against JAX `moe_forward_sorted`'s one-device branch at B 3, where its
    capacity from S over all B * S tokens drops tokens."""
    name, k = VARIANTS[variant]
    jcfg, cfg = _pair(name, k, capacity_factor=cf, compute_dtype="float32")
    tree = _moe_tree(jcfg)
    x = _inputs(cfg)
    _assert_decisive(_jax_probs(jcfg, tree, x), k)
    want = np.asarray(jax_blocks.moe_forward_sorted(jax.tree.map(jnp.asarray, tree), jcfg,
                                                    jnp.asarray(x)))
    layer = _port_moe(cfg, tree)
    with torch.no_grad():
        got = layer.forward_sorted(torch.from_numpy(x))
        einsum = layer(torch.from_numpy(x))
        blocks.set_moe_impl("sorted")
        try:
            switched = layer(torch.from_numpy(x))
        finally:
            blocks.set_moe_impl("einsum")
    np.testing.assert_allclose(got.numpy(), want, rtol=F32, atol=F32)
    assert torch.equal(switched, got)
    assert not torch.allclose(einsum, got)       # another function once tokens drop


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_matches_moe_decode(variant):
    """`MoE.decode` of one token a row (B 5) against JAX `moe_decode`."""
    name, k = VARIANTS[variant]
    jcfg, cfg = _pair(name, k, compute_dtype="float32")
    tree = _moe_tree(jcfg)
    x = _inputs(cfg, B=5, S=1, pads=())
    _assert_decisive(_jax_probs(jcfg, tree, x), k)
    want = np.asarray(jax_blocks.moe_decode(jax.tree.map(jnp.asarray, tree), jcfg,
                                            jnp.asarray(x)))
    layer = _port_moe(cfg, tree)
    with torch.no_grad():
        got = layer.decode(torch.from_numpy(x))
        assert bool(layer.routing(torch.from_numpy(x))["kept"].all())
    np.testing.assert_allclose(got.numpy(), want, rtol=F32, atol=F32)


def test_router_stays_float32_when_serving_in_bf16():
    cfg = get_config(SCOUT + "-smoke")
    assert cfg.compute_dtype == "bfloat16"
    served = lm.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    jtree = jax.tree.map(np.array, jax_lm.init_params(jax_get_config(SCOUT + "-smoke"),
                                                      jax.random.PRNGKey(0)))
    bridged = bridge.from_jax(cfg, jtree, device="cpu")
    for model in (served, bridged):
        p = dict(model.named_parameters())
        assert p["layers.0.mlp.router"].dtype == torch.float32
        assert p["layers.0.mlp.norm"].dtype == torch.float32
        assert p["layers.0.mlp.experts.w_gate"].dtype == torch.bfloat16
        assert p["layers.0.mlp.experts.w_down"].shape == (4, 64, 64)
        assert p["layers.0.mlp.shared.w_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        dict(bridged.named_parameters())["layers.1.mlp.router"].numpy(),
        jtree["layers"]["pos0"]["mlp"]["router"][1])


class _Shapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("sorted_", [False, True])
def test_dispatch_builds_no_capacity_one_hot(sorted_):
    """No tensor of the forward, nor of its backward, has the einsum
    path's four axes (B, S, E, C): the widest are (B, S, E) and the
    experts' (E, rows, D)."""
    _, cfg = _pair(SCOUT, 2, compute_dtype="float32")
    layer = blocks.MoE(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                       param_dtype=torch.float32)
    x = torch.randn(3, 32, cfg.d_model, requires_grad=True)
    with _Shapes() as mode:
        y = layer.forward_sorted(x) if sorted_ else layer(x)
        y.sum().backward()
    assert mode.shapes and max(len(s) for s in mode.shapes) <= 3, \
        sorted({s for s in mode.shapes if len(s) > 3})


# -- the models ---------------------------------------------------------------
def _model_tree(jcfg):
    """JAX `init_params`, each MoE router at fan-in scale and each norm
    random around 1."""
    tree = jax.tree.map(np.array, jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for pos in tree["layers"].values():
        for part in pos.values():
            if "router" in part:
                part["router"] = (rng.normal(size=part["router"].shape)
                                  * jcfg.d_model ** -0.5).astype(np.float32)
            part["norm"] = (1 + 0.1 * rng.normal(size=part["norm"].shape)).astype(np.float32)
    return tree


def _prompts(cfg, lens=(24, 13)):
    """Right-aligned prompts padded with token 0 to the longest, as the
    server batches them."""
    rng = np.random.default_rng(2)
    toks = np.zeros((len(lens), max(lens)), np.int64)
    for i, n in enumerate(lens):
        toks[i, max(lens) - n:] = rng.integers(2, cfg.vocab, n)
    feed = [rng.integers(2, cfg.vocab, (len(lens), 1)).astype(np.int64) for _ in range(3)]
    return toks, feed


@pytest.mark.parametrize("name", [SCOUT, MAVERICK])
def test_prefill_and_decode_match_jax(name):
    """Logits and caches of a prefill over padded prompts and 3 decode
    steps, through ``bridge.from_jax``, against JAX ``impl="ref"`` in
    float32 (1e-4)."""
    jcfg, cfg = _pair(name, compute_dtype="float32")
    tree = _model_tree(jcfg)
    model = bridge.from_jax(cfg, tree, device="cpu")
    toks, feed = _prompts(cfg)
    cap = toks.shape[1] + len(feed)
    params = jax.tree.map(jnp.asarray, tree)
    jl, jc = jax_lm.prefill(jcfg, params, {"tokens": jnp.asarray(toks)}, capacity=cap,
                            impl="ref")
    with torch.no_grad():
        tl, tc = lm.prefill(cfg, model, {"tokens": torch.from_numpy(toks)}, capacity=cap)
        steps = [(jl, jc, tl.clone(), tc)]
        for tok in feed:
            jl, jc = jax_lm.decode_step(jcfg, params, jc, jnp.asarray(tok), impl="ref")
            tl, tc = lm.decode_step(cfg, model, tc, torch.from_numpy(tok))
            steps.append((jl, jc, tl.clone(), tc))
    n = len(cfg.block_pattern)
    for jl, jc, tl, tc in steps:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for i, c in enumerate(tc["layers"]):
        for leaf, value in c.items():
            np.testing.assert_allclose(value.numpy(),
                                       np.asarray(jc["layers"][f"pos{i % n}"][leaf][i // n]),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", [SCOUT, MAVERICK])
def test_loss_and_every_gradient_match_jax(name):
    """`loss_fn` and every leaf's gradient (router, experts, shared
    included) against ``jax.value_and_grad(lm.loss_fn, impl="ref")`` in
    float32, at the default capacity over 40 tokens (tokens drop)."""
    jcfg, cfg = _pair(name, compute_dtype="float32")
    tree = _model_tree(jcfg)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
             for k in ("tokens", "labels")}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_lm.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
                                 impl="ref"), has_aux=True)(jax.tree.map(jnp.asarray, tree))
    model = bridge.from_jax(cfg, tree, device="cpu", param_dtype=torch.float32)
    loss, _ = lm.loss_fn(cfg, model, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    assert float(loss) == pytest.approx(float(jloss), rel=F32)
    want = bridge._flat_jax(cfg, jax.tree.map(np.asarray, jgrads))
    names = {k for k, _ in model.named_parameters()}
    assert {"layers.1.mlp.router", "layers.1.mlp.experts.w_down",
            "layers.1.mlp.shared.w_gate"} <= names
    for k, p in model.named_parameters():
        w = np.asarray(want[k], np.float32)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-7, err_msg=k)


# -- Adafactor over the stacked leaves -----------------------------------------
def test_jax_leaf_groups_follow_the_stacking():
    cfg = get_config(MAVERICK + "-smoke")             # pattern (dense, moe), 4 layers
    names = ["embed", "layers.0.mlp.w_up", "layers.1.mlp.router", "layers.2.mlp.w_up",
             "layers.3.mlp.router", "final_norm"]
    assert jax_leaf_groups(cfg, names) == [
        ["embed"], ["layers.0.mlp.w_up", "layers.2.mlp.w_up"],
        ["layers.1.mlp.router", "layers.3.mlp.router"], ["final_norm"]]


def test_adafactor_step_clips_over_the_stacked_periods():
    """Three Adafactor steps on maverick-smoke's 2 periods (every leaf of
    the tree, stacked in the JAX layout) equal JAX `adafactor` within 1e-6
    relative plus 1e-7.  The gradients of period 1 grow tenfold a step
    against period 0's, so each period's update has its own RMS and the
    clip binds differently on the stacked leaf than on each layer alone."""
    jcfg, cfg = _pair(MAVERICK, compute_dtype="float32")
    tree = _model_tree(jcfg)
    rng = np.random.default_rng(5)

    def grads_at(step):
        def one(path, leaf):
            g = rng.normal(size=leaf.shape).astype(np.float32)
            if path[0].key == "layers":
                g[1] *= 10.0 ** step
            return g
        return jax.tree_util.tree_map_with_path(one, tree)

    sched = (1e-2, 1, 10)
    jopt = jax_adafactor(jax_cosine(*sched), weight_decay=0.1)
    opt = get_optimizer("adafactor", cosine_schedule(*sched), cfg=cfg, weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    model = bridge.from_jax(cfg, tree, device="cpu", param_dtype=torch.float32)
    params = dict(model.named_parameters())
    state = opt.init(params)
    for step in range(3):
        g = grads_at(step)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.asarray(step, jnp.int32))
        flat = bridge._flat_jax(cfg, g)
        with torch.no_grad():
            opt.update({k: torch.from_numpy(np.ascontiguousarray(flat[k])) for k in params},
                       state, params, step)
    want = bridge._flat_jax(cfg, jax.tree.map(np.asarray, jp))
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_train_step_wires_the_leaf_groups():
    """`make_train_step` gives Adafactor the config's leaf groups: its
    update of maverick-smoke equals one made with them explicitly."""
    from repro_torch.launch.steps import make_train_step
    cfg = dataclasses.replace(get_config(MAVERICK + "-smoke"), compute_dtype="float32")
    opt, _ = make_train_step(cfg, lr=1e-2, warmup=1, total_steps=10)
    ref = adafactor(cosine_schedule(1e-2, 1, 10), leaf_groups=functools.partial(
        jax_leaf_groups, cfg))
    models = [lm.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                             param_dtype=torch.float32) for _ in range(2)]
    g = torch.Generator().manual_seed(1)
    grads = {k: torch.randn(p.shape, generator=g) * (1 + 9 * k.startswith("layers.3"))
             for k, p in models[0].named_parameters()}
    for o, m in zip((opt, ref), models):
        params = dict(m.named_parameters())
        state = o.init(params)
        for step in range(2):
            o.update(grads, state, params, step)
    for (k, a), (_, b) in zip(models[0].named_parameters(), models[1].named_parameters()):
        assert torch.equal(a, b), k


# -- the microbatch pipeline ---------------------------------------------------
@pytest.fixture
def jax_ref_impl():
    from repro.kernels import ops as jax_ops
    saved = jax_ops._DEFAULT_IMPL
    jax_ops.set_default_impl("ref")
    yield
    jax_ops.set_default_impl(saved)


@pytest.mark.parametrize("name", [SCOUT, MAVERICK])
def test_moe_stages_match_block_fwd(jax_ref_impl, name):
    """Each block stage (two layers, MoE among them) from the same weights
    (`bridge.stages_from_jax`), on the same float32 input: the output, the
    input's gradient and every parameter's gradient against JAX
    `_block_fwd` under ``jax.vjp`` (1e-4 of the largest entry)."""
    jcfg, cfg = _pair(name)
    names, fwds, params = jax_build_lm_stages(jcfg, layers_per_stage=2, seed=1)
    rng = np.random.default_rng(0)
    for n in names[1:-1]:
        for li in params[n]:
            mlp = params[n][li]["mlp"]
            if "router" in mlp:
                mlp["router"] = jnp.asarray(rng.normal(size=mlp["router"].shape)
                                            * cfg.d_model ** -0.5, jnp.float32)
    modules = bridge.stages_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu",
                                     layers_per_stage=2)
    assert any(isinstance(m, blocks.MoE) for m in modules[names[1]].modules())
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    for n in names[1:-1]:
        y, vjp = jax.vjp(fwds[n], params[n], jnp.asarray(x))
        y_bar = rng.normal(size=y.shape).astype(np.float32)
        p_bar, x_bar = vjp(jnp.asarray(y_bar))
        xt = torch.from_numpy(x).requires_grad_()
        yt = modules[n](xt)
        named = list(modules[n].named_parameters())
        gs = torch.autograd.grad(yt, [p for _, p in named] + [xt], torch.from_numpy(y_bar))
        want = bridge.flat_tree(jax.tree.map(np.asarray, p_bar))
        pairs = [("y", np.asarray(y), yt.detach().numpy()),
                 ("x_bar", np.asarray(x_bar), gs[-1].numpy())]
        pairs += [(k, want[k], g.numpy()) for (k, _), g in zip(named, gs)]
        for k, a, b in pairs:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * np.abs(a).max() + 1e-7,
                                       err_msg=f"{n}.{k}")


def test_lm_pipeline_1f1b_over_scout_is_the_oracle():
    """1F1B over scout-smoke's MoE stages: gradients and losses bitwise the
    sequential oracle's, the serve bitwise `reference()`'s; the router
    keeps its float32 master inside the run."""
    cfg = get_config(SCOUT + "-smoke")
    shape = ShapeCfg("moe_pipe", 16, 8, "train")
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=4)
    pipe = LMPipeline(cfg, stg, Selection.smallest(stg), device="cpu")
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
    assert any("router" in k for t in grads.values() for k in bridge.flat_tree(t))
    for a, b in zip(served.outputs, ref):
        assert torch.equal(a, b)


def test_serve_cli_runs_scout():
    srv, outs = serve.main(["--arch", SCOUT, "--reduced", "--device", "cpu", "--requests", "3",
                            "--max-new", "4", "--prompt-len", "20", "--seed", "1"])
    assert len(outs) == 3 and all(1 <= len(o.tokens) <= 4 for o in outs)
    assert isinstance(srv.params.layers[0].mlp, blocks.MoE)


def test_build_model_takes_both_configs_and_refuses_jamba():
    """Both MoE decoders build, and so does jamba, whose MoE follows a
    Mamba2 mixer (no longer refused: ``tests/test_torch_hybrid.py``)."""
    for name in (SCOUT, MAVERICK, "jamba-1.5-large-398b"):
        cfg = get_config(name)
        assert lm.build_model(cfg).cfg is cfg
    smoke = lm.init_params(get_config("jamba-1.5-large-398b-smoke"), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert isinstance(smoke.layers[1].mixer, blocks.Mamba)
    assert isinstance(smoke.layers[1].mlp, blocks.MoE)


def test_decode_pipeline_serves_scout_as_the_single_device_server():
    """The planner's decode pipeline over scout-smoke's MoE layers (one
    period a stage) gives the single-device server's tokens."""
    from repro_torch.core import planner
    from repro_torch.runtime.pipeline import DecodePipeline
    from repro_torch.runtime.server import LMServer, Request
    cfg = get_config(SCOUT + "-smoke")
    shape = ShapeCfg("moe_decode", 128, 16, "decode")
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
    finally:
        pipe.close()
    assert [o.tokens for o in got] == [o.tokens for o in want]
