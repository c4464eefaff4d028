"""The port's LM against the JAX package's, and the port's contracts.

Parameters come from the JAX ``init_params`` (bias leaves, and the Mamba
norms, ``dt_bias``, ``a_log`` and ``d_skip``, made random with numpy, so
that each is exercised) and reach the port through ``bridge.from_jax``.
The configs are the dense ones and mamba2-370m reduced, also with no MLP
(``d_ff=0``) as at full width.  The JAX side runs its ``impl="ref"`` tier on the CPU
as the oracle; the port runs its kernel route (the kernels' plain versions
on the CPU) and its own ``ref`` route.

Tolerances: float32 compute 1e-4 on logits and caches (two layers of
float32 matmuls summed in another order by each framework); bf16 compute
0.1 on logits of magnitude ~3, about six bf16 steps there (bf16 rounds
each projection and norm, and the two frameworks differ in the float32
bits that decide those roundings, so single steps differ and add up).
"""
import dataclasses
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.runtime.server import LMServer

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ["tiny", "qwen2.5-3b-smoke", "h2o-danube-3-4b-smoke", "mamba2-370m-smoke",
           "mamba2-370m-smoke-no-mlp"]
TOL = {"float32": 1e-4, "bfloat16": 1e-1}
# leaves drawn at random around these values, so the test sees them
RANDOM_LEAVES = {"bq": 0.0, "bk": 0.0, "bv": 0.0, "dt_bias": 0.0, "a_log": 0.0,
                 "d_skip": 1.0, "gate_norm": 1.0, "norm": 1.0}


def _config(get, name, **kw):
    """``<name>-no-mlp``: the config with ``d_ff=0``."""
    if name.endswith("-no-mlp"):
        return dataclasses.replace(get(name[:-7]), d_ff=0, **kw)
    return dataclasses.replace(get(name), **kw)


def _setup(name, compute_dtype):
    jcfg = _config(jax_get_config, name, compute_dtype=compute_dtype)
    cfg = _config(get_config, name, compute_dtype=compute_dtype)
    tree = jax.tree.map(np.array, jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    leaves = tree["layers"]["pos0"]["mixer"]
    for key, center in RANDOM_LEAVES.items():
        if key in leaves:
            leaves[key] = (center + rng.normal(scale=0.1, size=leaves[key].shape)
                           ).astype(np.float32)
    return jcfg, cfg, tree, bridge.from_jax(cfg, tree, device="cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _run_jax(jcfg, tree, toks, cap, feed):
    params = jax.tree.map(jnp.asarray, tree)
    logits, cache = jax_lm.prefill(jcfg, params, {"tokens": jnp.asarray(toks)},
                                   capacity=cap, impl="ref")
    out = [(logits, cache)]
    for tok in feed:
        logits, cache = jax_lm.decode_step(jcfg, params, cache, jnp.asarray(tok), impl="ref")
        out.append((logits, cache))
    return out


def _run_port(cfg, model, toks, cap, feed, impl=None):
    logits, cache = lm.prefill(cfg, model, {"tokens": torch.from_numpy(toks)},
                               capacity=cap, impl=impl)
    out = [(logits.clone(), [{k: v.clone() for k, v in c.items()} for c in cache["layers"]])]
    for tok in feed:
        logits, cache = lm.decode_step(cfg, model, cache, torch.from_numpy(tok), impl=impl)
        out.append((logits.clone(), [{k: v.clone() for k, v in c.items()}
                                     for c in cache["layers"]]))
    return out


def _inputs(cfg):
    """A prompt longer than the window for the windowed config, so the
    prefill takes the ring roll and the decode steps wrap."""
    rng = np.random.default_rng(2)
    S = 80 if cfg.attn is not None and cfg.attn.window else 24
    toks = rng.integers(0, cfg.vocab, (2, S)).astype(np.int64)
    feed = [rng.integers(0, cfg.vocab, (2, 1)).astype(np.int64) for _ in range(4)]
    return toks, S + len(feed) + 2, feed


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax_ref(name, dtype):
    jcfg, cfg, tree, model = _setup(name, dtype)
    toks, cap, feed = _inputs(cfg)
    want = _run_jax(jcfg, tree, toks, cap, feed)
    got = _run_port(cfg, model, toks, cap, feed)
    tol = TOL[dtype]
    for (jl, jc), (tl, tc) in zip(want, got):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=tol, rtol=tol)
        if dtype == "float32":      # bf16 caches differ by whole bf16 steps
            n = len(cfg.block_pattern)
            for i, c in enumerate(tc):
                assert c.keys() == jc["layers"][f"pos{i % n}"].keys()
                for leaf, value in c.items():
                    np.testing.assert_allclose(
                        _np(value), _np(jc["layers"][f"pos{i % n}"][leaf][i // n]),
                        atol=tol, rtol=tol)


@pytest.mark.parametrize("name", CONFIGS)
def test_kernel_route_matches_ref_route(name):
    _, cfg, _, model = _setup(name, "float32")
    toks, cap, feed = _inputs(cfg)
    a = _run_port(cfg, model, toks, cap, feed)
    b = _run_port(cfg, model, toks, cap, feed, impl="ref")
    for (la, ca), (lb, cb) in zip(a, b):
        torch.testing.assert_close(la, lb, atol=1e-5, rtol=1e-5)
        for x, y in zip(ca, cb):
            for leaf in x:
                torch.testing.assert_close(x[leaf], y[leaf], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", [None, "ref"])
def test_decode_step_updates_the_cache_in_place(impl):
    cfg = get_config("h2o-danube-3-4b-smoke")
    model = lm.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 70), generator=torch.Generator().manual_seed(1))
    _, cache = lm.prefill(cfg, model, {"tokens": toks}, capacity=72, impl=impl)
    tensors = [cache["pos"]] + [t for c in cache["layers"] for t in c.values()]
    ptrs = [t.data_ptr() for t in tensors]
    slot = 70 % cache["layers"][0]["k"].shape[1]
    before = cache["layers"][0]["k"][:, slot].clone()
    for _ in range(3):
        _, out = lm.decode_step(cfg, model, cache, toks[:, -1:], impl=impl)
        assert out is cache
    now = [cache["pos"]] + [t for c in cache["layers"] for t in c.values()]
    assert all(a is b for a, b in zip(tensors, now))
    assert [t.data_ptr() for t in now] == ptrs
    assert int(cache["pos"]) == 73
    assert not torch.equal(cache["layers"][0]["k"][:, slot], before)   # written in place


@pytest.mark.parametrize("impl", [None, "ref"])
def test_mamba_decode_updates_its_caches_in_place(impl):
    cfg = get_config("mamba2-370m-smoke")
    model = lm.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 20), generator=torch.Generator().manual_seed(1))
    _, cache = lm.prefill(cfg, model, {"tokens": toks}, capacity=24, impl=impl)
    tensors = [t for c in cache["layers"] for t in c.values()]
    ptrs = [t.data_ptr() for t in tensors]
    before = [t.clone() for t in tensors]
    _, out = lm.decode_step(cfg, model, cache, toks[:, -1:], impl=impl)
    assert out is cache
    now = [t for c in cache["layers"] for t in c.values()]
    assert all(a is b for a, b in zip(tensors, now))
    assert [t.data_ptr() for t in now] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip(now, before))     # each one written
    conv = cache["layers"][0]["conv"]
    torch.testing.assert_close(conv[:, :-1], before[0][:, 1:])          # the tail shifted


@pytest.mark.parametrize("impl", [None, "ref"])
def test_mamba_gate_goes_through_the_gated_norm_on_the_kernel_route(monkeypatch, impl):
    """A Mamba block's skip, gate and gate norm: one call of the gated
    wrapper a prefill and a decode step on the kernel route, and none (the
    op-by-op body) on the ref route; both give the same output."""
    from repro_torch.kernels import ops
    from repro_torch.models.blocks import Mamba

    calls = []
    gated = ops.rmsnorm_gated
    monkeypatch.setattr(ops, "rmsnorm_gated", lambda *a, **kw: calls.append(1) or gated(*a, **kw))
    cfg = dataclasses.replace(get_config("mamba2-370m-smoke"), compute_dtype="float32")
    layer = Mamba(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 6, cfg.d_model, generator=torch.Generator().manual_seed(1))
    out, (conv, ssm) = layer(x, impl=impl)
    assert len(calls) == (1 if impl is None else 0)
    cache = {"conv": conv.clone(), "ssm": ssm.clone()}
    step, _ = layer.decode(x[:, -1:], cache, impl=impl)
    assert len(calls) == (2 if impl is None else 0)
    want, (conv, ssm) = layer(x, impl="ref")
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    want, _ = layer.decode(x[:, -1:], {"conv": conv, "ssm": ssm}, impl="ref")
    torch.testing.assert_close(step, want, atol=1e-5, rtol=1e-5)


def test_unported_families_are_refused():
    """No family is refused any more: every architecture of the JAX
    registry builds, the hybrid (an MoE MLP after a Mamba2 mixer,
    ``tests/test_torch_hybrid.py``) among them, at full size on the meta
    device (no storage)."""
    from repro.configs import ARCHS as JAX_ARCHS
    for name in JAX_ARCHS:
        cfg = get_config(name)
        assert lm.build_model(cfg).cfg is cfg
        params = lm.LM(cfg, device="meta")
        assert all(p.is_meta for p in params.parameters())
    jamba = lm.LM(get_config("jamba-1.5-large-398b"), device="meta")
    assert type(jamba.layers[1].mixer).__name__ == "Mamba" and jamba.layers[1].moe


def test_bridge_refuses_a_tree_of_another_config():
    _, _, tree, _ = _setup("tiny", "float32")
    with pytest.raises(ValueError):
        bridge.from_jax(get_config("qwen2.5-3b-smoke"), tree, device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMServer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.from_jax(cfg, {})
    assert LMServer(cfg, device="cpu").device.type == "cpu"


_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path.insert(0, "src")
import repro_torch
for name in ("repro_torch.core", "repro_torch.graphs", "repro_torch.analysis",
             "repro_torch.runtime.pipeline"):
    importlib.import_module(name)
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len([k for k in sys.modules if k.startswith("repro_torch")]), bad)
assert not bad, bad
# the paper's STG path, the serving CLI and the mesh modules are among them
new = ["core.intra_node", "core.transform", "core.simulate", "graphs.jpeg", "graphs.nbody",
       "graphs.streamit", "runtime.pipeline.interpreter", "runtime.pipeline.schedule",
       "launch.serve", "configs.nemotron4_15b", "configs.deepseek_coder_33b",
       "runtime.pipeline.lm_pipe", "configs.seamless_m4t_medium", "configs.internvl2_26b",
       "configs.llama4_scout", "configs.llama4_maverick", "configs.jamba_1_5_large",
       "launch.steps", "analysis.step_cost", "launch.mesh", "launch.sharding",
       "sharding_ctx", "optim.compress", "launch.dryrun", "analysis.collectives"]
missing = [m for m in new if "repro_torch." + m not in sys.modules]
assert not missing, missing
# importing the dry run starts no process group
import torch.distributed as dist
assert not dist.is_initialized()
"""


def test_port_imports_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_source_names_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pat.finditer(f.read_text())]
    assert not hits, hits
