"""The port's training path against the JAX package's, on the CPU.

The JAX side is the oracle: its data pipeline, its ``lm.loss_fn`` under
``jax.value_and_grad`` with ``impl="ref"``, its optimizers and schedule,
and its unjitted ``make_train_step(cfg, impl="ref")``.  Parameters come
from the JAX ``init_params`` (the bias leaves and the Mamba scalars made
random with numpy, so that their gradients are exercised) and reach the
port as float32 masters through ``bridge.from_jax(..., param_dtype=
torch.float32)``.

Tolerances:
  * batches: bitwise;
  * float32 compute: loss within 1e-5 relative, every gradient element
    within 1e-4 of its leaf's largest JAX entry (two layers of float32
    products summed in another order by each framework; observed ~1e-5);
  * bf16 compute: loss within 2e-3 relative and each leaf's gradient within
    0.2 of its JAX norm, relative L2 (bf16 rounds every projection, and the
    two frameworks differ in the float32 bits that decide those roundings:
    a leaf whose gradient is a sum of small terms of both signs, such as
    Mamba's ``a_log``, moves most);
  * optimizer updates, 3 steps: 1e-6 relative plus 1e-7 absolute (both run
    the update's float32 arithmetic in the same order; the libraries' float32
    kernels may round a last bit apart);
  * two train steps: as float32 compute, loss 1e-5 relative, parameters
    after the steps within 1e-5 of their largest entry.
"""
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCfg as JaxShape
from repro.data import DataState as JaxDataState
from repro.data import make_pipeline as jax_make_pipeline
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import lm as jax_lm
from repro.optim import adafactor as jax_adafactor
from repro.optim import adamw as jax_adamw
from repro.optim import cosine_schedule as jax_cosine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.data import DataState, make_pipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.optim import adafactor, adamw, cosine_schedule

ROOT = pathlib.Path(__file__).resolve().parents[1]
# leaves drawn at random around these values, so that their gradients matter
RANDOM_LEAVES = {"bq": 0.0, "bk": 0.0, "bv": 0.0, "dt_bias": 0.0, "a_log": 0.0,
                 "d_skip": 1.0, "gate_norm": 1.0, "norm": 1.0}
CONFIGS = ["tiny", "qwen2.5-3b-smoke", "h2o-danube-3-4b-smoke", "mamba2-370m-smoke"]


def _setup(name, compute_dtype="float32", **kw):
    jcfg, cfg = jax_get_config(name), get_config(name)
    jcfg = dataclasses.replace(jcfg, compute_dtype=compute_dtype, **kw)
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype, **kw)
    tree = jax.tree.map(np.array, jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for pos in tree["layers"].values():
        for part in pos.values():
            for key, center in RANDOM_LEAVES.items():
                if key in part:
                    part[key] = (center + rng.normal(scale=0.1, size=part[key].shape)
                                 ).astype(np.float32)
    return jcfg, cfg, tree


def _batch(cfg, b=2, s=40, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _port_grads(cfg, tree, batch):
    model = bridge.from_jax(cfg, tree, device="cpu", param_dtype=torch.float32)
    loss, _ = lm.loss_fn(cfg, model, _torch_batch(batch))
    loss.backward()
    return float(loss), {k: p.grad for k, p in model.named_parameters()}


# -- the data pipeline -------------------------------------------------------
@pytest.mark.parametrize("kind", ["bigram", "uniform"])
@pytest.mark.parametrize("seed,step,host,n_hosts", [(0, 0, 0, 1), (3, 5, 1, 2), (11, 2, 3, 4),
                                                    (2 ** 31 - 1, 12345, 0, 2)])
def test_batches_are_bitwise_the_jax_pipelines(kind, seed, step, host, n_hosts):
    jcfg, cfg = jax_get_config("qwen2.5-3b").reduced(), get_config("qwen2.5-3b").reduced()
    want = jax_make_pipeline(kind, jcfg, JaxShape("c", 33, 8, "train"), seed=seed, accum=2)
    got = make_pipeline(kind, cfg, ShapeCfg("c", 33, 8, "train"), seed=seed, accum=2)
    wb = want.host_batch(JaxDataState(step, seed), host, n_hosts)
    gb = got.host_batch(DataState(step, seed), host, n_hosts)
    for key in ("tokens", "labels"):
        assert gb[key].dtype == np.int32 and gb[key].shape == (2, 8 // n_hosts // 2, 33)
        np.testing.assert_array_equal(gb[key], np.asarray(wb[key]))


def test_bigram_table_at_a_full_vocabulary_is_the_jax_one():
    jcfg, cfg = jax_get_config("qwen2.5-3b"), get_config("qwen2.5-3b")
    want = jax_make_pipeline("bigram", jcfg, JaxShape("c", 8, 2, "train"), seed=5, accum=1)
    got = make_pipeline("bigram", cfg, ShapeCfg("c", 8, 2, "train"), seed=5, accum=1)
    np.testing.assert_array_equal(got._succ, np.asarray(want._succ))
    np.testing.assert_array_equal(got.host_batch(DataState(3, 5))["tokens"],
                                  np.asarray(want.host_batch(JaxDataState(3, 5))["tokens"]))


# -- loss and gradients ------------------------------------------------------
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_match_jax(name, compute_dtype):
    jcfg, cfg, tree = _setup(name, compute_dtype)
    batch = _batch(cfg)
    (want_loss, _), jgrads = jax.value_and_grad(
        lambda p: jax_lm.loss_fn(jcfg, p, batch, impl="ref"), has_aux=True)(tree)
    want = bridge._flat_jax(cfg, jax.tree.map(np.asarray, jgrads))
    loss, got = _port_grads(cfg, tree, batch)
    assert got.keys() == want.keys()
    if compute_dtype == "float32":
        assert loss == pytest.approx(float(want_loss), rel=1e-5)
        for k, g in got.items():
            w = torch.from_numpy(np.asarray(want[k], dtype=np.float32))
            torch.testing.assert_close(g, w, atol=1e-4 * float(w.abs().max()) + 1e-12,
                                       rtol=0, msg=k)
    else:
        assert loss == pytest.approx(float(want_loss), rel=2e-3)
        for k, g in got.items():
            w = torch.from_numpy(np.asarray(want[k], dtype=np.float32))
            assert float((g - w).norm() / (w.norm() + 1e-12)) < 0.2, k


@pytest.mark.parametrize("name", CONFIGS)
def test_remat_modes_give_the_same_gradients(name):
    """``full`` and ``dots`` recompute what ``none`` keeps: on the CPU the
    recomputation repeats the same float operations, so the gradients are
    bitwise those of ``none``."""
    _, cfg, tree = _setup(name)
    batch = _batch(cfg, s=24)
    loss, want = _port_grads(dataclasses.replace(cfg, remat="none"), tree, batch)
    for remat in ("full", "dots"):
        got_loss, got = _port_grads(dataclasses.replace(cfg, remat=remat), tree, batch)
        assert got_loss == loss
        assert all(torch.equal(got[k], want[k]) for k in want), remat


def test_chunked_loss_pads_and_masks_as_jax():
    """A length off the chunk (S 700 = 512 + 188) and a mask: the JAX
    ``chunked_lm_loss`` on the same hidden states and head."""
    from repro.models.common import chunked_lm_loss as jax_loss
    from repro_torch.models.common import chunked_lm_loss
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 700, 16)).astype(np.float32)
    head = rng.normal(size=(16, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 700)).astype(np.int32)
    mask = (rng.random((2, 700)) > 0.3).astype(np.float32)
    want = float(jax_loss(jnp.asarray(x), jnp.asarray(head), jnp.asarray(labels),
                          jnp.asarray(mask)))
    got = chunked_lm_loss(torch.from_numpy(x), torch.from_numpy(head),
                          torch.from_numpy(labels), torch.from_numpy(mask))
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_logits_fn_matches_jax():
    jcfg, cfg, tree = _setup("qwen2.5-3b-smoke")
    batch = _batch(cfg)
    want = np.asarray(jax_lm.logits_fn(jcfg, tree, batch, impl="ref", last_only=False))
    model = bridge.from_jax(cfg, tree, device="cpu", param_dtype=torch.float32)
    with torch.no_grad():
        got = lm.logits_fn(cfg, model, _torch_batch(batch), last_only=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_serving_parameters_stay_frozen_in_the_compute_dtype():
    cfg = get_config("tiny")
    serve = lm.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    train = lm.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                           param_dtype=torch.float32)
    for (k, s), (_, t) in zip(serve.named_parameters(), train.named_parameters()):
        assert not s.requires_grad and t.requires_grad
        assert t.dtype == torch.float32
        assert s.dtype == (torch.float32 if k.endswith("norm") else torch.bfloat16), k
        assert torch.equal(s, t.to(s.dtype)), k      # one draw, cast for serving


# -- optimizers and schedule ------------------------------------------------
def _opt_tree():
    rng = np.random.default_rng(9)
    shapes = {"w": (24, 40), "big": (2, 128, 160), "b": (40,), "layers.0.norm": (40,)}
    return ({k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()},
            [{k: rng.normal(scale=0.5, size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)])


@pytest.mark.parametrize("which", ["adamw", "adamw_clipped", "adafactor"])
def test_optimizer_updates_match_jax(which):
    sched_args = (1e-2, 1, 10)
    kw = {"adamw": {}, "adamw_clipped": {"clip_norm": 0.5},
          "adafactor": {"weight_decay": 0.1}}[which]
    jmake, make = ((jax_adafactor, adafactor) if which == "adafactor" else (jax_adamw, adamw))
    jopt, opt = jmake(jax_cosine(*sched_args), **kw), make(cosine_schedule(*sched_args), **kw)
    params, grads = _opt_tree()

    def stacked(tree):    # a layer's leaf carries the period axis in the JAX layout
        return {k: jnp.asarray(v[None] if k.startswith("layers.") else v)
                for k, v in tree.items()}
    jp = stacked(params)
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for step, g in enumerate(grads):
        jp, js = jopt.update(stacked(g), js, jp, jnp.asarray(step, jnp.int32))
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, step)
    for k in params:
        want = np.asarray(jp[k])
        np.testing.assert_allclose(tp[k].numpy(), want[0] if k.startswith("layers.") else want,
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    if which == "adafactor":          # the 3-d leaf is factored, the others are not
        assert set(ts["f"]["big"]) == {"vr", "vc"} and set(ts["f"]["w"]) == {"v"}


def test_cosine_schedule_matches_jax():
    j, t = jax_cosine(3e-4, 50, 1000), cosine_schedule(3e-4, 50, 1000)
    for step in (0, 1, 25, 49, 50, 51, 400, 999, 1000, 5000):
        assert t(step) == pytest.approx(float(j(jnp.asarray(step, jnp.int32))), rel=1e-6)


# -- the train step ----------------------------------------------------------
def test_two_train_steps_with_accumulation_match_jax():
    """Two `make_train_step` steps, accum 2, AdamW on the cosine schedule,
    against JAX's unjitted ``make_train_step(cfg, impl="ref")`` on the same
    float32 masters and the same batches."""
    jcfg, cfg, tree = _setup("qwen2.5-3b-smoke", grad_accum=2)
    kw = dict(lr=1e-3, warmup=1, total_steps=10)
    _, jopt, jstep = jax_make_train_step(jcfg, impl="ref", **kw)
    opt, step_fn = make_train_step(cfg, **kw)
    pipe = make_pipeline("bigram", cfg, ShapeCfg("c", 32, 4, "train"), seed=1, accum=2)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    model = bridge.from_jax(cfg, tree, device="cpu", param_dtype=torch.float32)
    state = opt.init(dict(model.named_parameters()))
    for step in range(2):
        batch = pipe.host_batch(DataState(step, 1))
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(step, jnp.int32), batch)
        m = step_fn(model, state, step, _torch_batch(batch))
        assert m["step"] == step + 1
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    want = bridge._flat_jax(cfg, jax.tree.map(np.asarray, jparams))
    for k, p in model.named_parameters():
        w = torch.from_numpy(np.asarray(want[k], dtype=np.float32))
        torch.testing.assert_close(p.detach(), w, atol=1e-5 * float(w.abs().max()), rtol=0,
                                   msg=k)


def test_train_step_refuses_a_serving_model():
    cfg = get_config("tiny")
    _, step_fn = make_train_step(cfg)
    with pytest.raises(ValueError, match="param_dtype"):
        step_fn(lm.init_params(cfg, device="cpu", generator=torch.Generator()), {}, 0,
                {"tokens": torch.zeros(1, 1, 4, dtype=torch.long)})


_IMPORT_TRAINING = """
import sys
sys.path.insert(0, "src")
import repro_torch.runtime.trainer, repro_torch.launch.train, repro_torch.launch.steps
import repro_torch.optim, repro_torch.data, repro_torch.checkpoint
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
"""


def test_training_modules_import_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", _IMPORT_TRAINING], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
