"""The port's mesh and sharding on the CPU, over gloo: N ranks, each a
process, as ``torchrun`` would start them on N cards.

One helper (`_spawn`) starts the ranks with ``torch.multiprocessing``,
joins them through a ``file://`` store under ``tmp_path`` (no port, so
parallel test workers cannot collide), gives each one torch thread, and
kills them and fails after 120 s, so a deadlocked collective costs 120 s.
The cases run in three spawns (module fixtures), each rank writing what
it measured to a file that the tests below read:

  * world 4: (i) ``train_loop`` of qwen2.5-3b ``reduced()`` in float32 at
    mesh (2, 2) with ``tp=2, fsdp=True``, at (4, 1) with ``fsdp=True`` and
    at (1, 4) with ``tp=4`` (the model axis splits inside a kv head; with
    6 query heads, inside the query heads too), and of mamba2-370m and
    llama4-scout (the einsum MoE, each rank dispatching its own rows)
    ``reduced()`` at (2, 2), against the port's one-device
    ``train_loop`` (held to JAX in ``tests/test_torch_trainer.py`` and
    ``test_torch_train.py``): losses and final parameters within 1e-5
    relative; (iv) the elastic drill; (v) ``LMServer(mesh=)`` at (1, 4)
    by both routes against the one-device server; (vi) ``ShardCtx.pin``'s
    placements against the spec JAX's ``pin`` constrains to;
  * world 8: (ii) the int8 ring against JAX ``compressed_mean`` under
    ``jax.vmap(axis_name="data")`` on the same rows (within one quantum:
    XLA fuses a hop's multiply-add on the CPU); (iii) the sorted MoE
    at mesh (4, 2) against JAX ``_sorted_dispatch_local(ep_axes="data",
    tp_axis="model")`` under a nested ``jax.vmap``;
  * world 2: (v) ``LMServer(mesh=)`` at tp 2 against the one-device
    server.

The JAX oracles run in the test process before the spawn; the ranks
import no JAX.
"""
import dataclasses
import os
import pickle
import time

import numpy as np
import pytest
import torch

TIMEOUT_S = 120.0
F32 = 1e-5


# -- the spawn helper ---------------------------------------------------------
def _child(rank, world, store, case, payload, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        result = (CASES[case] if isinstance(case, str) else case)(rank, world, payload)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path, world: int, case, payload=None) -> list:
    """Runs ``CASES[case](rank, world, payload)`` on ``world`` gloo ranks
    (or ``case(...)``, a module-level function of another test module);
    returns each rank's result.  Fails (after killing the ranks) past
    TIMEOUT_S or when a rank fails."""
    import torch.multiprocessing as mp
    name = case if isinstance(case, str) else case.__name__
    out = tmp_path / f"{name}-out"
    out.mkdir()
    store = tmp_path / f"{name}-store"
    ctx = mp.start_processes(_child, args=(world, str(store), case, payload, str(out)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.1, min(2.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                pytest.fail(f"{name}: {world} ranks did not finish in {TIMEOUT_S:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as fh:
            results.append(pickle.load(fh))
    return results


# -- the ranks' cases ---------------------------------------------------------
def _f32(name="qwen2.5-3b"):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name).reduced(), compute_dtype="float32")



def _loop(**kw):
    from repro_torch.runtime.trainer import TrainLoopConfig
    base = dict(steps=3, seq_len=16, global_batch=4, log_interval=1, lr=1e-3, warmup=1)
    base.update(kw)
    return TrainLoopConfig(**base)


def _full_params(model) -> dict:
    return {k: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().clone()
            for k, p in model.named_parameters()}


def _placements(t) -> list:
    return [repr(p) for p in t.placements]


def _world4(rank, world, payload):
    from repro_torch import sharding_ctx as sc
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.runtime.trainer import train_loop
    cfg = _f32()
    out = {}
    # (i) training at (2, 2) tp=2 fsdp, (4, 1) fsdp and (1, 4) tp=4 (2 kv heads:
    # the model axis splits inside a head; with 6 query heads also inside the
    # out-projection's input, whose gradient comes back split so);
    # mamba2-370m at (2, 2)
    h6 = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn, n_heads=6))
    for name, c, shape, kw in (("2x2", cfg, (2, 2), dict(tp=2, fsdp=True)),
                               ("4x1", cfg, (4, 1), dict(fsdp=True)),
                               ("1x4", cfg, (1, 4), dict(tp=4)),
                               ("h6-1x4", h6, (1, 4), dict(tp=4)),
                               ("mamba-2x2", _f32("mamba2-370m"), (2, 2), dict(tp=2, fsdp=True)),
                               ("moe-2x2", _f32("llama4-scout-17b-a16e"), (2, 2),
                                dict(tp=2, fsdp=True))):
        mesh = device_mesh(shape, ("data", "model"), device="cpu")
        s = train_loop(c, _loop(**kw), device="cpu", mesh=mesh)
        layout = {k: _placements(p) for k, p in s.model.named_parameters()}
        out[name] = {"losses": s.losses, "params": _full_params(s.model), "layout": layout}
    if rank == 0:
        for name, c in (("one", cfg), ("h6-one", h6), ("mamba-one", _f32("mamba2-370m")),
                        ("moe-one", _f32("llama4-scout-17b-a16e"))):
            s = train_loop(c, _loop(), device="cpu")
            out[name] = {"losses": s.losses, "params": _full_params(s.model)}
    # (vi) pins at (2, 2)
    mesh = device_mesh((2, 2), ("data", "model"), device="cpu")
    pins = []
    for shape, axes, ep_data in payload["pins"]:
        ctx = sc.from_mesh(mesh, ep_data=ep_data)
        x = shd.place(torch.zeros(shape), shd.NamedSharding(mesh, shd.P()))
        pins.append(_placements(ctx.pin(x, *axes)))
    out["pins"] = pins
    # (v) serving at (1, 4), by the kernels' route and by the oracle's
    mesh = device_mesh((1, 4), ("data", "model"), device="cpu")
    for impl in (None, "ref"):
        out[f"serve-1x4-{impl}"] = _serve(cfg, mesh, payload["reqs"], rank, impl)
    out["submeshes"] = _submeshes(rank, cfg)
    out["drill"] = _drill(rank, world, payload["ckpt"])
    return out


def _submeshes(rank, cfg):
    """`submesh_of` over ranks (2, 3) and the cases it refuses, and a block
    stage's parameters placed on the sub-mesh by `stage_param_shardings`."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import mesh_ranks, submesh_of
    from repro_torch.runtime.pipeline.lm_pipe import build_lm_stages
    sub = submesh_of((2, 3), device="cpu")
    refused = [submesh_of(r, device="cpu") for r in ((1,), (2, 2), (3, 7))]
    _, stages = build_lm_stages(cfg, device="cpu")
    sh = shd.stage_param_shardings("block00", stages["block00"], sub, cfg)
    shd.distribute_params(stages["block00"], sh)
    wq = dict(stages["block00"].named_parameters())["l0.mix.wq"]
    return {"shape": tuple(sub.mesh.shape), "ranks": mesh_ranks(sub),
            "refused": refused, "wq": _placements(wq),
            "wq_local": tuple(wq.to_local().shape)}


def _recording_pipeline(seen: list):
    """`data.make_pipeline`, its host batches' tokens recorded by step."""
    from repro_torch.data import make_pipeline

    def make(*a, **kw):
        pipe = make_pipeline(*a, **kw)
        host_batch = pipe.host_batch

        def recorded(state):
            batch = host_batch(state)
            seen.append((state.step, batch["tokens"].copy()))
            return batch
        pipe.host_batch = recorded
        return pipe
    return make


def _drill(rank, world, ckpt_dir):
    """(iv) train at (2, 2) with tp 2 and fsdp, crash at step 2; rescale to
    2 chips (ranks 0 and 1) and resume there, crash at step 4; grow back
    to 4 chips and finish 6 steps.  Checkpoints every 2 steps."""
    import torch.distributed as dist

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import planner
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import mesh_ranks
    from repro_torch.runtime import elastic, trainer
    from repro_torch.runtime.failures import FailureInjector, SimulatedNodeFailure
    cfg = _f32()
    shape = ShapeCfg("drill", 16, 4, "train")
    seen: list = []
    trainer.make_pipeline = _recording_pipeline(seen)
    out = {"losses": {}, "meshes": []}

    def log(rec):
        out["losses"][rec["step"]] = rec["loss"]

    def run(mesh, crash_at, **kw):
        loop = _loop(steps=6, ckpt_dir=ckpt_dir, ckpt_interval=2, on_metrics=log,
                     failures=FailureInjector({crash_at: "crash"}) if crash_at else None, **kw)
        try:
            s = trainer.train_loop(cfg, loop, device="cpu", mesh=mesh)
        except SimulatedNodeFailure:
            return None
        return s

    plan4 = planner.plan(cfg, shape, chips=4)
    run(trainer.local_mesh(2, device="cpu"), 2, tp=2, fsdp=True)
    shrunk = elastic.rescale(cfg, shape, plan4, new_chips=2, ranks=[0, 1], device="cpu")
    out["meshes"].append((tuple(shrunk.mesh.mesh.shape), mesh_ranks(shrunk.mesh)))
    if rank in mesh_ranks(shrunk.mesh):
        # the checkpoint's parameters restored onto the new mesh, two ways
        like = {"params": dict(trainer.lm.init_params(
            cfg, device="cpu", generator=torch.Generator().manual_seed(0),
            param_dtype=torch.float32).named_parameters())}
        full, _ = restore_checkpoint(ckpt_dir, like)
        tree, sh = elastic.reshard_tree(full["params"], shrunk.mesh, cfg)
        placed, _ = restore_checkpoint(ckpt_dir, like, shardings={"params": sh})
        out["reshard"] = all(
            torch.equal(placed["params"][k].to_local(), tree[k].to_local())
            and placed["params"][k].placements == tree[k].placements for k in tree)
        run(shrunk.mesh, 4, fsdp=True)
    dist.barrier()
    grown = elastic.rescale(cfg, shape, shrunk.plan, new_chips=4, device="cpu")
    out["meshes"].append((tuple(grown.mesh.mesh.shape), mesh_ranks(grown.mesh)))
    s = run(grown.mesh, None, fsdp=True)
    out["restored_from"] = s.restored_from
    out["batches"] = seen
    if rank == 0:
        seen_one: list = []
        trainer.make_pipeline = _recording_pipeline(seen_one)
        one = trainer.train_loop(cfg, _loop(steps=6), device="cpu")
        out["one"] = {"losses": one.losses, "batches": seen_one}
    return out


def _ring(rank, world, payload):
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.optim import compress
    mesh = device_mesh((world,), ("data",), device="cpu")
    rows = torch.from_numpy(payload["rows"])
    group = mesh.get_group("data")
    got = compress.compressed_mean(rows[rank], group, world)
    sync = compress.make_compressed_sync(mesh, "data")
    state = compress.CompressionState.init({"w": torch.zeros(rows.shape[1])}, world)
    acc = torch.zeros(rows.shape[1], dtype=torch.float64)
    for _ in range(30):
        synced, state = sync({"w": rows[rank]}, state)
        acc += synced["w"].double()
    (q, s), err = compress.ef_compress(rows[rank], torch.from_numpy(payload["err"][rank]))
    return {"mean": got.numpy(), "ef_mean": (acc / 30).numpy(),
            "ef": (q.numpy(), s.numpy(), err.numpy())}


def _moe(rank, world, payload):
    from repro_torch import sharding_ctx as sc
    from repro_torch.bridge import flat_tree
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import blocks
    mesh = device_mesh((4, 2), ("data", "model"), device="cpu")
    out = {}
    for name, (cfg, tree, x, g) in payload.items():
        layer = blocks.MoE(cfg, device="cpu")
        with torch.no_grad():
            for k, p in layer.named_parameters():
                p.copy_(torch.from_numpy(np.asarray(flat_tree(tree)[k], np.float32)))
        layer.requires_grad_(True)
        policy = shd.ShardingPolicy(fsdp=False, ep_axis="data")
        shd.distribute_params(layer, shd.tree_shardings(layer, mesh, cfg, policy))
        xd = shd.place(torch.from_numpy(x), shd.NamedSharding(mesh, shd.P(("data",))))
        xd.requires_grad_()
        with sc.activate(sc.from_mesh(mesh, ep_data=True)):
            got = layer.forward_sorted(xd)
        got = got.full_tensor()
        (got * torch.from_numpy(g)).sum().backward()      # the cotangent g
        grads = {k: p.grad.full_tensor().numpy() for k, p in layer.named_parameters()}
        out[name] = {"out": got.detach().numpy(), "experts": _placements(layer.experts.w_up),
                     "grads": {"x": xd.grad.full_tensor().numpy(), **grads}}
    return out


def _world8(rank, world, payload):
    return {"ring": _ring(rank, world, payload["ring"]), "moe": _moe(rank, world, payload["moe"])}


def _serve(cfg, mesh, payload, rank, impl=None):
    """``cfg`` served at ``mesh`` by ``impl``'s route; rank 0 also serves it
    on one device and replays those tokens for the top-2 margins."""
    from repro_torch.models import lm
    from repro_torch.runtime.server import LMServer, Request
    reqs = [Request(u, p, m) for u, p, m in payload]

    def model():
        return lm.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))

    srv = LMServer(cfg, max_batch=2, params=model(), mesh=mesh, impl=impl)
    out = {"tokens": [c.tokens for c in srv.serve(reqs)],
           "layout": {k: _placements(p) for k, p in srv.params.named_parameters()}}
    if rank == 0:
        one = LMServer(cfg, max_batch=2, params=model(), device="cpu", impl=impl)
        out["one"] = [c.tokens for c in one.serve(reqs)]
        out["margins"] = []
        for lo in range(0, len(reqs), 2):
            rnd = [(r.uid, r.prompt, r.max_new) for r in reqs[lo:lo + 2]]
            out["margins"] += list(_margins(cfg, one.params, rnd, out["one"][lo:lo + 2]))
    return out


def _world2(rank, world, payload):
    """(v) qwen2.5-3b ``reduced()`` in float32 served at mesh (1, 2), and
    the kernel wrappers on DTensors."""
    from repro_torch.launch.mesh import device_mesh
    mesh = device_mesh((1, 2), ("data", "model"), device="cpu")
    out = _serve(_f32(), mesh, payload, rank)
    out["wrappers"] = _wrappers(mesh)
    return out


def _wrappers(mesh):
    """Each kernel wrapper of `kernels.ops` on DTensor inputs (replicated;
    the wrapper lays them out: batch and heads split, rows split) against
    itself on the plain tensors, forward: the largest difference."""
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as shd
    g = torch.Generator().manual_seed(5)

    def r(*shape):
        return torch.randn(shape, generator=g)

    def d(t):
        return shd.place(t, shd.NamedSharding(mesh, shd.P()))

    q, k, v = r(2, 6, 4, 8), r(2, 6, 2, 8), r(2, 6, 2, 8)
    qd, kc, vc, n = r(2, 4, 8), r(2, 16, 2, 8), r(2, 16, 2, 8), torch.tensor([16, 9])
    x, w = r(2, 6, 32), r(32)
    ssd_in = (r(2, 8, 4, 8), torch.rand(2, 8, 4, generator=g), -torch.rand(4, generator=g),
              r(2, 8, 16), r(2, 8, 16))
    gated = (r(2, 6, 4, 8), r(2, 6, 4, 8), r(4), r(2, 6, 32), r(32))
    cases = {
        "attention": (ops.attention, (q, k, v)),
        "decode_attention": (ops.decode_attention, (qd, kc, vc, n)),
        "rmsnorm": (ops.rmsnorm, (x, w)),
        "rmsnorm_gated": (ops.rmsnorm_gated, gated),
        "ssd": (ops.ssd, ssd_in),
    }
    out = {}
    for name, (fn, args) in cases.items():
        want = fn(*args)
        got = fn(*(d(a) for a in args))
        pairs = zip(want, got) if isinstance(want, tuple) else [(want, got)]
        out[name] = max(float((gt.full_tensor() - wt).abs().max()) for wt, gt in pairs)
    return out


def _margins(cfg, model, reqs, tokens):
    """Top-2 logit margin at each step of each request, replaying
    ``tokens`` through ``model`` as the server batches them."""
    from repro_torch.models import lm
    from repro_torch.runtime.server import _bucket
    B = len(reqs)
    bucket = _bucket(max(len(p) for _, p, _ in reqs))
    toks = np.zeros((B, bucket), np.int64)
    for i, (_, p, _) in enumerate(reqs):
        toks[i, bucket - len(p):] = p
    cap = bucket + max(m for _, _, m in reqs)
    with torch.no_grad():
        logits, cache = lm.prefill(cfg, model, {"tokens": torch.from_numpy(toks)},
                                   capacity=cap)
        out = []
        for t in range(max(len(x) for x in tokens)):
            top2 = torch.topk(logits[:, -1].float(), 2, dim=-1).values
            out.append((top2[:, 0] - top2[:, 1]).tolist())
            feed = [[x[t] if t < len(x) else 0] for x in tokens]
            logits, cache = lm.decode_step(cfg, model, cache, torch.tensor(feed))
    return np.array(out).T


CASES = {"world4": _world4, "world8": _world8, "world2": _world2}


# -- (i) and (vi): world 4 ----------------------------------------------------
PIN_CASES = [
    ((4, 16, 4, 8), ("dp", None, "tp", None), False),
    ((4, 16, 3, 8), ("dp", None, "tp", None), False),     # 3 heads: "tp" dropped
    ((3, 16, 64), ("dp", "sp", None), False),             # batch 3: "dp" dropped
    ((4, 16, 512), ("dp", None, "tp"), False),
    ((4, 8, 6), ("dp", None, "tp"), False),
    ((4, 8, 2, 2), ("ep_tok", "ep", None, None), False),
    ((4, 8, 2, 2), ("ep_tok", "ep", None, None), True),
    ((4, 2, 8, 16), ("dp", "tp", None, None), False),
]


def _jax_pin_specs():
    """The spec JAX ``ShardCtx.pin`` constrains each case to, on an
    abstract (2, 2) mesh (``with_sharding_constraint`` recorded, not run)."""
    import jax
    from repro import sharding_ctx as jsc
    mesh = jax.sharding.AbstractMesh((2, 2), ("data", "model"))
    seen = []
    real = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = lambda x, s: seen.append(tuple(s.spec)) or x
    try:
        for shape, axes, ep_data in PIN_CASES:
            jsc.from_mesh(mesh, ep_data=ep_data).pin(
                jax.ShapeDtypeStruct(shape, np.float32), *axes)
    finally:
        jax.lax.with_sharding_constraint = real
    return seen


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w4")
    reqs = _requests(np.random.default_rng(3), max_new=8)   # capacities 24 and 40
    return _spawn(tmp, 4, "world4", {"pins": PIN_CASES, "ckpt": str(tmp / "ckpt"),
                                     "reqs": reqs})


def _requests(rng, max_new=6):
    return [(i, rng.integers(2, 500, rng.integers(3, 20)).tolist(), max_new) for i in range(3)]


@pytest.mark.parametrize("mesh", ["2x2", "4x1", "1x4", "h6-1x4", "mamba-2x2", "moe-2x2"])
def test_train_loop_on_a_mesh_equals_one_device(world4, mesh):
    family = mesh.split("-")[0] if "-" in mesh else None
    one = world4[0][f"{family}-one" if family else "one"]
    for rank in world4:
        got = rank[mesh]
        assert got["losses"].keys() == one["losses"].keys() == {0, 1, 2}
        np.testing.assert_allclose([got["losses"][i] for i in range(3)],
                                   [one["losses"][i] for i in range(3)], rtol=F32, atol=0)
        for k, want in one["params"].items():
            torch.testing.assert_close(got["params"][k], want, rtol=F32, atol=F32)


def test_train_loop_places_params_by_the_jax_specs(world4):
    """tp=2 and fsdp at (2, 2): wq (D, H*hd) is split over data (FSDP) on
    dim 0 and over model on dim 1; at (4, 1) fsdp alone."""
    lay2, lay4 = world4[0]["2x2"]["layout"], world4[0]["4x1"]["layout"]
    assert lay2["layers.0.mixer.wq"] == ["Shard(dim=0)", "Shard(dim=1)"]
    assert lay2["layers.0.mixer.wo"] == ["Shard(dim=1)", "Shard(dim=0)"]
    assert lay2["embed"] == ["Shard(dim=1)", "Shard(dim=0)"]
    assert lay2["layers.0.mixer.norm"] == ["Replicate()", "Replicate()"]
    assert lay4["layers.0.mixer.wq"] == ["Shard(dim=0)", "Replicate()"]


def test_pin_gives_the_jax_pin_placements(world4):
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.sharding import to_placements
    mesh = AbstractMesh((2, 2), ("data", "model"))
    want = [[repr(p) for p in to_placements(s, mesh)] for s in _jax_pin_specs()]
    assert want[1][1] == "Replicate()" and want[2][0] == "Replicate()"
    for rank in world4:
        assert rank["pins"] == want


def test_submesh_of_and_stage_shardings(world4):
    """A (1, 2) sub-mesh over ranks 2 and 3 (built by all four ranks): a
    block stage's wq split over "model" there, ranks 0 and 1 holding no
    shard; None for one rank, repeated ranks and ranks past the world."""
    d_model = _f32().d_model
    for r, rank in enumerate(world4):
        got = rank["submeshes"]
        assert got["shape"] == (1, 2) and got["ranks"] == [2, 3]
        assert got["refused"] == [None, None, None]
        assert got["wq"] == ["Replicate()", "Shard(dim=1)"]
        if r >= 2:
            assert got["wq_local"][0] == d_model
        else:
            assert 0 in got["wq_local"]


# -- (ii) and (iii): world 8 --------------------------------------------------
def _jax_ring(rows, err):
    import jax
    import jax.numpy as jnp
    from repro.optim.compress import compressed_mean, ef_compress
    mean = jax.vmap(lambda x: compressed_mean(x, "data", rows.shape[0]),
                    axis_name="data")(jnp.asarray(rows))
    ef = [ef_compress(jnp.asarray(r), jnp.asarray(e)) for r, e in zip(rows, err)]
    return np.asarray(mean), [(np.asarray(q), np.asarray(s), np.asarray(e))
                              for (q, s), e in ef]


def _moe_pair(cf):
    """(JAX config, port config) of llama4-scout ``reduced()`` with 8
    experts, top-2, capacity factor ``cf``, in float32."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    out = []
    for get in (jax_get_config, get_config):
        cfg = get("llama4-scout-17b-a16e").reduced()
        moe = dataclasses.replace(cfg.moe, n_experts=8, top_k=2, capacity_factor=cf)
        out.append(dataclasses.replace(cfg, moe=moe, compute_dtype="float32"))
    return tuple(out)


def _jax_moe(jcfg, B=8, S=16, seed=0):
    """The sharded sorted MoE's JAX oracle at mesh (4, 2) = ("data",
    "model"): `_sorted_dispatch_local` with its collectives under a nested
    ``jax.vmap``, each (data, model) instance on its shard of the tokens
    and of the experts, as ``moe_forward_sorted``'s ``shard_map`` body;
    then the shared expert and the residual.  Also JAX ``moe_forward``, and
    ``jax.vjp`` of the sharded oracle at a random cotangent ``g``: the
    gradients of x and of every weight ({port name: gradient})."""
    import jax
    import jax.numpy as jnp
    from repro.models import blocks as jb
    from repro.models.common import KeyGen, rmsnorm
    from repro_torch.bridge import flat_tree
    tree = jax.tree.map(np.array, jb.init_moe(KeyGen(jax.random.PRNGKey(seed)), jcfg, "t"))
    rng = np.random.default_rng(seed + 1)
    tree["router"] = (rng.normal(size=tree["router"].shape) * jcfg.d_model ** -0.5
                      ).astype(np.float32)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    p = jax.tree.map(jnp.asarray, tree)
    e, D, nd, nm = jcfg.moe, jcfg.d_model, 4, 2
    h = rmsnorm(jnp.asarray(x), p["norm"], jcfg.norm_eps)
    probs = jax.nn.softmax(h.astype(jnp.float32) @ p["router"], axis=-1)
    top2 = np.sort(np.asarray(probs), axis=-1)[..., -3:]
    assert np.min(np.diff(top2, axis=-1)) > 1e-4          # decisive routing

    def shard(a, dim_d, dim_m):
        """(nd, nm, ...) stack of a's (data, model) shards."""
        rows = []
        for d in range(nd):
            ad = jnp.split(a, nd, axis=dim_d)[d] if dim_d is not None else a
            rows.append(jnp.stack([jnp.split(ad, nm, axis=dim_m)[m] if dim_m is not None
                                   else ad for m in range(nm)]))
        return jnp.stack(rows)

    def body(hl, pl, experts):
        n = hl.shape[0] * hl.shape[1]
        capl = max(1, int(n * e.capacity_factor * e.top_k / e.n_experts))
        out = jb._sorted_dispatch_local(hl.reshape(n, D), pl.reshape(n, e.n_experts), experts,
                                        jcfg, capl, ep_axes="data", tp_axis="model", n_ep=nd)
        return out.reshape(hl.shape)

    def sharded_moe(xj, pj):
        hj = rmsnorm(xj, pj["norm"], jcfg.norm_eps)
        pr = jax.nn.softmax(hj.astype(jnp.float32) @ pj["router"], axis=-1)
        ex = {k: shard(v, 0, 2 if k in ("w_gate", "w_up") else 1)
              for k, v in pj["experts"].items()}
        local = jax.vmap(jax.vmap(body, axis_name="model"), axis_name="data")(
            shard(hj, 0, None), shard(pr, 0, None), ex)
        out = jnp.concatenate([local[d, 0] for d in range(nd)])
        out = out + jb._ffn(pj["shared"], jcfg, hj).astype(out.dtype)
        return xj + out.astype(jnp.float32), local

    (sharded, local), vjp = jax.vjp(sharded_moe, jnp.asarray(x), p)
    local = np.asarray(local)
    assert all(np.array_equal(local[d, 0], local[d, 1]) for d in range(nd))
    g = rng.normal(size=x.shape).astype(np.float32)
    gx, gp = vjp((jnp.asarray(g), jnp.zeros_like(local)))
    grads = {"x": np.asarray(gx), **{k: np.asarray(v) for k, v in flat_tree(gp).items()}}
    sharded = np.asarray(sharded)
    einsum = np.asarray(jb.moe_forward(p, jcfg, jnp.asarray(x)))
    return tree, x, sharded, einsum, g, grads


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(8, 4096)).astype(np.float32)
    err = (rng.normal(size=(8, 4096)) * 0.01).astype(np.float32)
    mean, ef = _jax_ring(rows, err)
    moe, want = {}, {}
    for name, cf in (("cf1", 1.0), ("cf8", 8.0)):
        jcfg, cfg = _moe_pair(cf)
        tree, x, sharded, einsum, g, grads = _jax_moe(jcfg)
        moe[name] = (cfg, tree, x, g)
        want[name] = {"sharded": sharded, "einsum": einsum, "x": x, "grads": grads}
    got = _spawn(tmp_path_factory.mktemp("w8"), 8, "world8",
                 {"ring": {"rows": rows, "err": err}, "moe": moe})
    return {"got": got, "rows": rows, "err": err, "mean": mean, "ef": ef, "moe": want}


def test_ring_mean_is_the_jax_ring_within_one_quantum(world8):
    """Each rank's `compressed_mean` against JAX's row for it: within one
    quantum of the last stage (the all-gather's scale over n), and within
    the two quantization stages of the exact mean.  Not bit for bit,
    though both round half to even: XLA's CPU backend contracts each hop's
    ``dequantize_int8(q, s) + chunk`` into one fused multiply-add (one
    rounding), where the port multiplies and adds (two); a hop that rounds
    otherwise can move one element by one quantum."""
    exact = world8["rows"].mean(axis=0)
    quantum = np.abs(world8["mean"]).max() / 127
    for r, rank in enumerate(world8["got"]):
        assert np.abs(rank["ring"]["mean"] - world8["mean"][r]).max() <= quantum
        assert np.abs(rank["ring"]["mean"] - exact).max() < 0.15


def test_ring_hops_are_jax_hops_with_a_fused_multiply_add():
    """The claim above, on one process: the ring's hops replayed with an
    exact multiply-add (float64, then one rounding to float32) give JAX's
    reduce-scatter bit for bit, and with the port's arithmetic they do
    not."""
    import jax
    import jax.numpy as jnp
    from repro.optim.compress import ring_reduce_scatter_int8
    from repro_torch.optim.compress import dequantize_int8, quantize_int8
    n = 8
    rows = np.random.default_rng(0).normal(size=(n, 4096)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda r: ring_reduce_scatter_int8(r, "data", n),
                               axis_name="data")(jnp.asarray(rows)))

    def replay(fma):
        chunks = [torch.from_numpy(r).reshape(n, -1) for r in rows]
        cur = [quantize_int8(chunks[d][(d - 1) % n]) for d in range(n)]
        for i in range(n - 1):
            cur = [cur[(d - 1) % n] for d in range(n)]          # one hop
            nxt = []
            for d, (q, s) in enumerate(cur):
                c = chunks[d][(d - i - 2) % n]
                v = ((q.double() * s.double() + c.double()).float() if fma
                     else dequantize_int8(q, s) + c)
                nxt.append(quantize_int8(v))
            cur = nxt
        return np.stack([dequantize_int8(*c).numpy() for c in cur])

    np.testing.assert_array_equal(replay(fma=True), want)
    assert not np.array_equal(replay(fma=False), want)


def test_error_feedback_contract_and_drift(world8):
    """`ef_compress` equals JAX's bitwise, and dequant(q, s) + err' == x +
    err exactly; 30 EF syncs average to the exact mean within 0.02."""
    from repro_torch.optim.compress import dequantize_int8
    exact = world8["rows"].mean(axis=0)
    for r, rank in enumerate(world8["got"]):
        q, s, err = rank["ring"]["ef"]
        jq, js, jerr = world8["ef"][r]
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(err, jerr)
        lhs = dequantize_int8(torch.from_numpy(q), torch.from_numpy(s)) + torch.from_numpy(err)
        rhs = torch.from_numpy(world8["rows"][r]) + torch.from_numpy(world8["err"][r])
        assert torch.equal(lhs, rhs)
        assert np.abs(rank["ring"]["ef_mean"] - exact).max() < 0.02


@pytest.mark.parametrize("cf", ["cf1", "cf8"])
def test_sharded_sorted_moe_matches_the_jax_shard_map_body(world8, cf):
    """At capacity factor 1.0 tokens drop (the sharded oracle differs from
    the einsum dispatch); at 8.0 none does and both equal `moe_forward`."""
    want = world8["moe"][cf]
    for rank in world8["got"]:
        got = rank["moe"][cf]
        np.testing.assert_allclose(got["out"], want["sharded"], rtol=F32, atol=F32)
        assert got["experts"] == ["Shard(dim=0)", "Shard(dim=2)"]
    if cf == "cf8":
        np.testing.assert_allclose(want["sharded"], want["einsum"], rtol=F32, atol=F32)
    else:
        assert not np.allclose(want["sharded"], want["einsum"], rtol=F32, atol=F32)


@pytest.mark.parametrize("cf", ["cf1", "cf8"])
def test_sharded_sorted_moe_gradients_match_the_jax_vjp(world8, cf):
    """The backward of the sharded MoE (its all-to-alls, the gradient
    summed over "model" where the experts' F is split, and the row-parallel
    sum passing its gradient through) against ``jax.vjp`` of the same
    ``shard_map`` body under nested ``jax.vmap``: the gradients of x and of
    every weight, expert shards included, at one cotangent."""
    want = world8["moe"][cf]["grads"]
    for rank in world8["got"]:
        got = rank["moe"][cf]["grads"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=F32, atol=F32, err_msg=k)


# -- (iv): the elastic drill, world 4 ------------------------------------------
def test_elastic_drill_matches_an_uninterrupted_run(world4):
    """(2, 2) -> crash at step 2 -> `rescale` to 2 chips on ranks 0, 1 (the
    planner's (2, 1)) -> crash at step 4 -> grow back to 4 chips ((4, 1)):
    the six losses, each from the mesh that ran its step, equal the
    one-device run's within 1e-5, and every host batch, the ones fetched
    just before a crash included, is bitwise the uninterrupted run's of
    the same step.  Ranks 2 and 3 sit out steps 2 and 3."""
    one = world4[0]["drill"]["one"]
    want = dict((step, tokens) for step, tokens in one["batches"])
    for r, rank in enumerate(world4):
        d = rank["drill"]
        assert d["meshes"] == [((2, 1), [0, 1]), ((4, 1), [0, 1, 2, 3])]
        assert d["restored_from"] == 4
        ran = [0, 1, 2, 3, 4, 5] if r < 2 else [0, 1, 4, 5]
        assert sorted(d["losses"]) == ran
        np.testing.assert_allclose([d["losses"][i] for i in ran],
                                   [one["losses"][i] for i in ran], rtol=F32, atol=0)
        steps = [step for step, _ in d["batches"]]
        assert steps == ([0, 1, 2, 2, 3, 4, 4, 5] if r < 2 else [0, 1, 2, 4, 5])
        for step, tokens in d["batches"]:
            np.testing.assert_array_equal(tokens, want[step])


def test_reshard_tree_equals_restore_with_shardings(world4):
    """On the shrunk mesh, the checkpoint restored with ``shardings=`` and
    the full restore placed by `reshard_tree` hold the same shards."""
    for r in (0, 1):
        assert world4[r]["drill"]["reshard"]
    assert "reshard" not in world4[2]["drill"]


# -- (v): serving at tp 2, world 2 ---------------------------------------------
TIE = 1e-4


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("w2"), 2, "world2",
                  _requests(np.random.default_rng(3)))


def _same_tokens(ranks):
    """Each rank's tokens equal rank 0's one-device tokens up to a step
    whose top-2 margin is under TIE (the rule of the server tests)."""
    one, margins = ranks[0]["one"], ranks[0]["margins"]
    for rank in ranks:
        for i, (got, want) in enumerate(zip(rank["tokens"], one)):
            diff = [t for t, (a, b) in enumerate(zip(got, want)) if a != b]
            if diff:
                assert margins[i][diff[0]] < TIE, (i, diff[0], margins[i][diff[0]])
            else:
                assert len(got) == len(want)


def test_server_on_a_mesh_equals_one_device(world2):
    _same_tokens(world2)


@pytest.mark.parametrize("impl", [None, "ref"])
def test_server_at_tp4_equals_one_device(world4, impl):
    """At (1, 4) the model axis splits inside a kv head (2 heads of 16 over
    4 ranks): the projections are gathered over "model" before the head
    view, and each rank writes its own slot of a cache split over its
    capacity (24 and 40 slots, split as the kv heads cannot be)."""
    _same_tokens([rank[f"serve-1x4-{impl}"] for rank in world4])
    lay = world4[0][f"serve-1x4-{impl}"]["layout"]
    assert lay["layers.0.mixer.wk"] == ["Replicate()", "Shard(dim=1)"]


def test_kernel_wrappers_on_dtensors_equal_plain(world2):
    """At mesh (1, 2) every wrapper runs on its local shards (heads split
    for attention, decode attention and the scan, rows whole for the
    norms) and gives its plain result: each op is independent along the
    split dims."""
    for rank in world2:
        assert set(rank["wrappers"]) == {"attention", "decode_attention", "rmsnorm",
                                         "rmsnorm_gated", "ssd"}
        for name, err in rank["wrappers"].items():
            assert err <= 1e-6, (name, err)


def test_server_places_weights_by_the_jax_specs(world2):
    lay = world2[0]["layout"]
    assert lay["layers.0.mixer.wq"] == ["Replicate()", "Shard(dim=1)"]
    assert lay["layers.0.mixer.wo"] == ["Replicate()", "Shard(dim=0)"]
    assert lay["layers.0.mlp.w_up"] == ["Replicate()", "Shard(dim=1)"]


# -- the launcher at world 1, in this process ----------------------------------
def test_train_cli_with_fsdp_at_world_one(tmp_path):
    """``launch/train.py --fsdp`` (and ``--use-planner``) with no
    ``torchrun`` around: a gloo group of world 1 from a file store, a
    (1, 1) mesh, the same losses as the plain loop, bitwise."""
    import torch.distributed as dist

    from repro_torch.launch import train as train_cli
    argv = ["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu", "--steps", "3",
            "--seq-len", "16", "--global-batch", "2", "--log-interval", "1"]
    plain = train_cli.main(argv)
    try:
        meshed = train_cli.main(argv + ["--fsdp"])
        planned = train_cli.main(argv + ["--use-planner"])
        assert dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert meshed.losses == plain.losses == planned.losses
    assert hasattr(meshed.model.embed, "placements")
    assert not hasattr(plain.model.embed, "placements")
