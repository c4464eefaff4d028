"""The port's partition specs (`launch.sharding`, `launch.mesh`) and mesh
projection (`core.planner.to_execution`, `folded_tokens_per_s`) against the
JAX package's, with no process group: both sides on abstract meshes.

  * Every leaf of every `configs.ARCHS` entry at full size: the port's
    `tree_pspecs` of `launch.steps.abstract_params` (an `LM` on the meta
    device) equals JAX ``tree_pspecs`` of its ``abstract_params`` on a
    ``jax.sharding.AbstractMesh``, with the stacked leaves' period entry
    dropped (the port's layers are unstacked), on every mesh of
    ``MESHES`` (the production pod at tp 1-16, ``rep=2`` and two pods)
    under every policy (FSDP, TP and the expert axis on and off).
  * The same for `cache_specs` (JAX ``abstract_cache`` of a batch that
    divides and one that does not, with and without ``seq_shard_cache``),
    `batch_specs` (the warning included) and `stage_param_specs` (each
    stage of `lm_pipe.build_lm_stages` on the meta device over (1, tp)).
  * `to_placements` on multi-axis entries.
  * `to_execution` and `folded_tokens_per_s` on the same plans and the
    same `Hardware` numbers.
Each (arch, mesh) pair is a case of its own.
"""
import dataclasses
import itertools
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCfg as JaxShapeCfg
from repro.core import planner as jax_planner
from repro.launch import sharding as jax_shd
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.analysis.roofline import HW_V5E, Hardware as JaxHardware
from repro.runtime.pipeline.jax_pipe import build_lm_stages as jax_build_lm_stages
from repro_torch import bridge
from repro_torch.analysis.roofline import HW_H100, Hardware
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.core import planner
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.runtime.pipeline.lm_pipe import build_lm_stages

MESHES = {
    **{f"tp{tp}": dict(tp=tp) for tp in (1, 2, 4, 8, 16)},
    "rep2": dict(rep=2),
    "multi_pod": dict(multi_pod=True),
}
POLICIES = [dict(fsdp=f, tp=t, ep_axis=e)
            for f, t, e in itertools.product((True, False), (True, False), ("model", "data"))]


def _meshes(name):
    """(JAX AbstractMesh, port AbstractMesh) of the production mesh ``name``."""
    port = port_mesh.production_shape(**MESHES[name])
    return jax.sharding.AbstractMesh(port.sizes, port.axis_names), port


def _spec(s) -> tuple:
    return tuple(s)


class _Stacked:
    """A JAX spec of a stacked leaf: indexing it by a period (as the
    bridge indexes a stacked leaf) drops the period entry."""

    def __init__(self, spec):
        self.spec = _spec(spec)

    def __getitem__(self, period):
        return self.spec[1:]


def _wrap(tree):
    if isinstance(tree, dict):
        return {k: _wrap(v) for k, v in tree.items()}
    return _Stacked(tree)


def _jax_by_port_name(cfg, jax_specs) -> dict:
    """JAX's spec tree under the port's parameter names, layers unstacked."""
    flat = bridge._flat_jax(cfg, _wrap(jax_specs))
    return {k: v.spec if isinstance(v, _Stacked) else v for k, v in flat.items()}


@pytest.fixture(scope="module")
def abstract():
    """{arch: (JAX abstract params, port abstract params)} at full size."""
    out = {}
    for arch in ARCHS:
        jparams = jax_steps.abstract_params(jax_build_model(jax_get_config(arch)))
        out[arch] = (jparams, steps.abstract_params(get_config(arch)))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(abstract, arch, mesh):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jmesh, pmesh = _meshes(mesh)
    jparams, params = abstract[arch]
    for kw in POLICIES:
        want = _jax_by_port_name(cfg, jax_shd.tree_pspecs(
            jparams, jmesh, jcfg, jax_shd.ShardingPolicy(**kw)))
        got = {k: _spec(v) for k, v in shd.tree_pspecs(
            params, pmesh, cfg, shd.ShardingPolicy(**kw)).items()}
        assert got == want, kw


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch, mesh):
    """Decode caches of a batch of 32 (divides most data axes) and of 1
    (long context: capacity over "model", or over the data axes with
    ``seq_shard_cache``), each layer's leaf JAX's stacked leaf of its
    period."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jmesh, pmesh = _meshes(mesh)
    n = len(cfg.block_pattern)
    for batch, seq_shard in ((32, False), (1, False), (1, True)):
        sh = ShapeCfg("d", 4096, batch, "decode")
        jcache = jax_steps.abstract_cache(jax_build_model(jcfg), jcfg,
                                          JaxShapeCfg(**vars(sh)))
        cache = steps.abstract_cache(cfg, sh)
        want = jax_shd.cache_specs(jmesh, jcache, jcfg,
                                   jax_shd.ShardingPolicy(seq_shard_cache=seq_shard))
        got = shd.cache_specs(pmesh, cache, cfg, shd.ShardingPolicy(seq_shard_cache=seq_shard))
        assert _spec(got["pos"]) == _spec(want["pos"]) == ()
        assert len(got["layers"]) == cfg.n_layers
        for j, layer in enumerate(got["layers"]):
            stacked = want["layers"][f"pos{j % n}"]
            for path, spec in bridge.flat_tree(layer).items():
                node = stacked
                for k in path.split("."):
                    node = node[k]
                assert _spec(spec) == _spec(node)[1:], (j, path, batch, seq_shard)
        if cfg.encdec:
            assert _spec(got["cross_len"]) == ()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_jax(arch, mesh):
    """Train batches with and without accumulation, and a batch of 8 that
    no data axes of 16 or more divide: replicated, with JAX's warning."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jmesh, pmesh = _meshes(mesh)
    ndp = int(np.prod([pmesh.shape[a] for a in port_mesh.data_axes(pmesh)]))
    for batch, accum in ((512, None), (512, 4), (8, None)):
        sh = ShapeCfg("t", 256, batch, "train")
        jb = jax_steps.batch_struct(jcfg, JaxShapeCfg(**vars(sh)), accum=accum)
        pb = steps.batch_struct(cfg, sh, accum=accum)
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = jax_shd.batch_specs(jmesh, jb, accum=accum is not None)
        with warnings.catch_warnings(record=True) as pw:
            warnings.simplefilter("always")
            got = shd.batch_specs(pmesh, pb, accum=accum is not None)
        assert {k: _spec(v) for k, v in got.items()} == {k: _spec(v) for k, v in want.items()}
        rows = batch if accum is None else batch // accum
        assert len(pw) == len(jw) == (0 if rows % ndp == 0 else len(pb))
        assert [str(w.message) for w in pw] == [str(w.message) for w in jw]


@pytest.fixture(scope="module")
def stage_trees():
    """{arch: (JAX stage trees (abstract), port stage names and modules on
    the meta device)}, a layer a block stage."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jtrees = jax.eval_shape(lambda: jax_build_lm_stages(jax_get_config(arch))[2])
            cache[arch] = (jtrees, *build_lm_stages(get_config(arch), device="meta",
                                                    empty=True))
        return cache[arch]
    return get


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_stage_param_specs_equal_jax(stage_trees, arch, tp):
    """Each stage of the LM pipeline (a layer a block stage) over a (1, tp)
    sub-mesh, under the default stage policy (TP, no FSDP) and under
    FSDP with the experts on "data"."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jmesh = jax.sharding.AbstractMesh((1, tp), ("data", "model"))
    pmesh = port_mesh.AbstractMesh((1, tp), ("data", "model"))
    jtrees, names, stages = stage_trees(arch)
    assert sorted(names) == sorted(jtrees)
    for policy in (None, dict(fsdp=True, ep_axis="data")):
        jpol = policy and jax_shd.ShardingPolicy(**policy)
        ppol = policy and shd.ShardingPolicy(**policy)
        for name in names:
            want = bridge.flat_tree(jax_shd.stage_param_specs(name, jtrees[name], jmesh, jcfg,
                                                              jpol))
            got = shd.stage_param_specs(name, stages[name], pmesh, cfg, ppol)
            assert {k: _spec(v) for k, v in got.items()} == \
                {k: _spec(v) for k, v in want.items()}, (name, policy)


def test_to_placements_on_multi_axis_entries():
    from torch.distributed.tensor import Replicate, Shard
    mesh = port_mesh.production_shape(multi_pod=True, rep=2, tp=4)     # pod data rep model
    assert mesh.sizes == (2, 32, 2, 4)
    P = shd.P
    assert shd.to_placements(P(("pod", "data", "rep"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(0), Shard(1)]
    assert shd.to_placements(P(None, ("pod", "data")), mesh) == \
        [Shard(1), Shard(1), Replicate(), Replicate()]
    assert shd.to_placements(P(("data",), None, "model"), mesh) == \
        [Replicate(), Shard(0), Replicate(), Shard(2)]
    assert shd.to_placements(P(), mesh) == [Replicate()] * 4
    one = port_mesh.AbstractMesh((4, 1), ("data", "model"))
    assert shd.to_placements(P("data", "model"), one) == [Shard(0), Replicate()]
    with pytest.raises(ValueError):
        shd.to_placements(P(("data", "pod")), mesh)          # not in mesh order
    with pytest.raises(ValueError):
        shd.to_placements(P("model", "model"), mesh)


def test_production_shapes_equal_jax():
    from repro.launch import mesh as jax_mesh
    assert port_mesh.production_shape().shape == {"data": 16, "model": 16}
    for kw in MESHES.values():
        port = port_mesh.production_shape(**kw)
        assert port_mesh.data_axes(port) == tuple(a for a in port.axis_names if a != "model")
        assert port_mesh.mesh_device_count(port) == (512 if kw.get("multi_pod") else 256)
        assert jax_mesh.data_axes(jax.sharding.AbstractMesh(port.sizes, port.axis_names)) == \
            port_mesh.data_axes(port)
    with pytest.raises(ValueError):
        port_mesh.production_shape(tp=3)
    with pytest.raises(RuntimeError):
        port_mesh.make_production_mesh(device="cpu")          # no process group here


def test_stage_device_slices_equal_jax():
    """A plan's per-stage replica slices of a pool of 16 ranks, as JAX
    partitions its devices (integer handles on both sides)."""
    from repro.graphs import lm_graph as jax_lm_graph
    from repro.launch import mesh as jax_mesh
    from repro_torch.graphs import lm_graph
    cfg, jcfg = get_config("qwen2.5-3b").reduced(), jax_get_config("qwen2.5-3b").reduced()
    sh = ShapeCfg("d", 128, 16, "decode")
    jhw, phw = _hw_pair(HW_H100)
    jp = jax_planner.plan(jcfg, JaxShapeCfg(**vars(sh)), chips=16, max_tp=4, hw=jhw)
    pp = planner.plan(cfg, sh, chips=16, max_tp=4, hw=phw)
    jstg, _ = jax_lm_graph.build_stg(jcfg, JaxShapeCfg(**vars(sh)), max_tp=4)
    stg, _ = lm_graph.build_stg(cfg, sh, max_tp=4)
    from repro.runtime.pipeline import as_selection as jax_as_selection
    from repro_torch.runtime.pipeline import as_selection
    want = jax_mesh.stage_device_slices(list(range(16)), jstg, jax_as_selection(jp))
    got = port_mesh.stage_device_slices(list(range(16)), stg, as_selection(pp))
    assert got == want and len(got) > 2


def _hw_pair(hw):
    return JaxHardware(**dataclasses.asdict(hw)), Hardware(**dataclasses.asdict(hw))


PLAN_CASES = [("qwen2.5-3b", 8), ("qwen2.5-3b", 64), ("llama4-maverick-400b-a17b", 64),
              ("jamba-1.5-large-398b", 16), ("mamba2-370m", 4)]
# (name prefix, tp, replicas) of a plan's stages: a tp 4 majority with a
# residue, and a tie broken by first appearance
SYNTHETIC = [[("embed", 1, 1), *((f"block{i:02d}", 4, 2) for i in range(5)),
              ("block05", 2, 1), ("head", 1, 2)],
             [("embed", 2, 1), ("block00", 8, 1), ("block01", 2, 4), ("head", 1, 1)]]


def _plans(stages):
    """The same hand-made plan as a JAX and a port `PlanResult`."""
    out = []
    for mod in (jax_planner, planner):
        sp = [mod.StagePlan(n, f"tp{t}", t, r) for n, t, r in stages]
        out.append(mod.PlanResult(arch="x", shape="t", mode="max_throughput",
                                  engine="heuristic", stages=sp, total_chips=8.0,
                                  impl_chips=8.0, overhead_chips=0.0, v_firing_us=1.0,
                                  tokens_per_s=1.0, solve_seconds=0.0, feasible=True))
    return out


@pytest.mark.parametrize("arch,chips", PLAN_CASES)
def test_to_execution_and_folded_throughput_equal_jax(arch, chips):
    """Both planners plan the reduced config on `HW_H100`'s numbers (the
    port's plan is the JAX plan, stage for stage); `to_execution` of it, and of two hand-made
    plans with tp > 1 and a residue, equals JAX's for the full config at
    ``chips`` and a quarter of them; `folded_tokens_per_s` of the full
    config equals JAX's at tp 1, 4 and 16, on `HW_H100`'s numbers and on
    the TPU's (``HW_V5E``)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    sh = ShapeCfg("t", 4096, 256, "train")
    jsh = JaxShapeCfg(**vars(sh))
    small = ShapeCfg("t", 256, 32, "train")
    jhw, phw = _hw_pair(HW_H100)
    jp = jax_planner.plan(jcfg.reduced(), JaxShapeCfg(**vars(small)), chips=chips, max_tp=4,
                          hw=jhw)
    pp = planner.plan(cfg.reduced(), small, chips=chips, max_tp=4, hw=phw)
    assert [(s.name, s.tp, s.replicas) for s in pp.stages] == \
        [(s.name, s.tp, s.replicas) for s in jp.stages]
    for j, p in [(jp, pp), *(_plans(st) for st in SYNTHETIC)]:
        for n in (chips, max(1, chips // 4)):
            assert dataclasses.asdict(planner.to_execution(p, cfg=cfg, chips=n)) == \
                dataclasses.asdict(jax_planner.to_execution(j, cfg=jcfg, chips=n))
    assert planner.to_execution(_plans(SYNTHETIC[0])[1], chips=chips).tp == min(4, chips)
    for hw in (HW_H100, HW_V5E):
        jhw, phw = _hw_pair(hw)
        for tp in (1, 4, 16):
            want = jax_planner.folded_tokens_per_s(jcfg, jsh, chips=chips, tp=tp, hw=jhw)
            assert planner.folded_tokens_per_s(cfg, sh, chips=chips, tp=tp, hw=phw) == want
    assert planner.folded_tokens_per_s(cfg, sh, chips=chips, tp=1) == \
        planner.folded_tokens_per_s(cfg, sh, chips=chips, tp=1, hw=HW_H100)
