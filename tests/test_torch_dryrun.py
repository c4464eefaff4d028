"""The port's dry run (`repro_torch.launch.dryrun`) and its collective
count (`repro_torch.analysis.collectives`) against the JAX package's.

Every part that needs a fake process group runs in one subprocess for
the module (`_port_side`: rank 0 of a fake world of 256, the meshes over
its first ranks), so no default group is left in the test worker; a
second subprocess compiles the JAX side of (a) on 8 host devices.  The
two run at once.

  (a) Collectives against JAX: on 8 ranks, a (2, 4) ("data", "model")
      mesh (the int8 ring on an (8,) "data" mesh), four computations
      counted by `count_collectives` and by ``parse_collectives`` /
      ``hlo.collect`` of the same computation compiled by XLA: a
      tensor-parallel two-product MLP (one all-reduce), an FSDP weight
      gather (one all-gather), the expert-parallel sorted MoE (its
      all-to-alls and within-expert sums) and the int8 ring (its
      permutes).  Kinds, counts and wire bytes are equal, up to the
      classes `analysis.collectives` names.  Then two whole cells, the
      reduced qwen2.5-3b decode (2 kv heads at tp 4) and FSDP train
      steps, placed on both sides as the dry runs place them: each
      collective given the role it plays in the step; the role both
      run alike (decode: the row-parallel sums; train: the layers' FSDP
      weight gathers) equal in kinds, counts and elements, every other
      role a named class.
  (b) Reduced cells: one config a family, train and decode, on a fake
      (2, 4) mesh through `dryrun.dry_run`: the JAX result keys, the
      one-device FLOPs, each device's argument bytes from the specs, and
      a collective term.
  (c) qwen2.5-3b ``decode_32k`` at 16x16, full width: the model axis (16)
      splits its 2 kv heads of 128.
  (d) The CLI on mamba2-370m ``decode_32k`` with ``--no-save``.
"""
import contextlib
import dataclasses
import io
import math
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240

# -- (a) the JAX side, on 8 host devices ------------------------------------------------
_JAX_CASES = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import sharding_ctx as sc
    from repro.analysis import hlo
    from repro.analysis.roofline import parse_collectives
    from repro.configs import get_config
    from repro.models import blocks
    from repro.models.common import KeyGen
    from repro.optim.compress import compressed_mean

    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    ring_mesh = Mesh(np.array(jax.devices()), ("data",))
    out = {}

    def sds(shape, dt, m, spec):
        return jax.ShapeDtypeStruct(shape, dt, sharding=NamedSharding(m, spec))

    def report(name, compiled):
        text = compiled.as_text()
        tr = hlo.collect(text, 8)
        out[name] = {"parse": dataclasses.asdict(parse_collectives(text, 8)),
                     "collect": {"counts": tr.counts, "wire_bytes": tr.wire_bytes}}

    B, D, F = 16, 64, 128
    report("tp_mlp", jax.jit(lambda x, w1, w2: jax.nn.relu(x @ w1) @ w2,
                             out_shardings=NamedSharding(mesh, P("data", None))).lower(
        sds((B, D), jnp.bfloat16, mesh, P("data", None)),
        sds((D, F), jnp.bfloat16, mesh, P(None, "model")),
        sds((F, D), jnp.bfloat16, mesh, P("model", None))).compile())

    def fsdp(x, w):
        return x @ jax.lax.with_sharding_constraint(w, NamedSharding(mesh, P()))
    report("fsdp_gather", jax.jit(fsdp, out_shardings=NamedSharding(mesh, P("data", None))).lower(
        sds((B, D), jnp.float32, mesh, P("data", None)),
        sds((D, F), jnp.float32, mesh, P("data", None))).compile())

    cfg = get_config("llama4-scout-17b-a16e").reduced()
    cfg = dataclasses.replace(cfg, compute_dtype="float32", moe=dataclasses.replace(
        cfg.moe, top_k=2, n_experts=8, capacity_factor=2.0))
    p = jax.eval_shape(lambda: blocks.init_moe(KeyGen(jax.random.PRNGKey(0)), cfg, "t"))
    specs = jax.tree.map(lambda _: P(), p)
    specs["experts"] = {"w_gate": P("data", None, "model"), "w_up": P("data", None, "model"),
                        "w_down": P("data", "model", None)}
    pa = jax.tree.map(lambda t, s: sds(t.shape, t.dtype, mesh, s), p, specs)
    xa = sds((8, 16, cfg.d_model), jnp.float32, mesh, P("data", None, None))
    with mesh, sc.activate(sc.from_mesh(mesh, ep_data=True)):
        report("moe", jax.jit(lambda pp, xx: blocks.moe_forward_sorted(pp, cfg, xx),
                              out_shardings=NamedSharding(mesh, P("data", None, None))).lower(
            pa, xa).compile())

    from jax.experimental.shard_map import shard_map
    ring = shard_map(lambda r: compressed_mean(r[0], "data", 8)[None], mesh=ring_mesh,
                     in_specs=P("data"), out_specs=P("data"), check_rep=False)
    report("ring", jax.jit(ring).lower(sds((8, 4096), jnp.float32, ring_mesh, P("data"))).compile())

    # whole cells: the reduced qwen2.5-3b step placed as the JAX dry run places it
    import re
    from repro.configs.base import ShapeCfg
    from repro.launch import sharding as shd
    from repro.launch.steps import abstract_params, input_specs
    from repro.models import build_model

    def op_walk(text):      # hlo.collect's walk, op by op, each with its loops' trips
        comps = hlo.split_computations(text)
        entry = re.search(r"^ENTRY\\s+%?([\\w.\\-]+)", text, re.M).group(1)
        ops, seen = [], set()

        def walk(comp, mult):
            if comp not in comps or (comp, mult) in seen:
                return
            seen.add((comp, mult))
            for line in comps[comp]:
                cm = hlo._COLLECTIVE_LINE.search(line)
                if cm and hlo._group_size(line, 8) > 1:
                    name = re.search(r'op_name="([^"]*)"', line)
                    numel = sum(int(np.prod([int(d) for d in m.group(2).split(",") if d]))
                                for m in hlo._SHAPE_RE.finditer(cm.group(1))
                                if m.group(1) in hlo._DTYPE_BYTES)
                    ops.append({"kind": cm.group(2), "bytes": hlo._shape_bytes(cm.group(1)),
                                "numel": numel, "g": hlo._group_size(line, 8), "mult": mult,
                                "op_name": name.group(1) if name else ""})
                wm = hlo._WHILE_RE.search(line)
                if wm:
                    walk(wm.group(2), mult * hlo.trip_count(comps.get(wm.group(1), [])))
                    continue
                fm = hlo._CALL_RE.search(line)
                if fm:
                    walk(fm.group(1), mult)
        walk(entry, 1.0)
        return ops

    cfg = get_config("qwen2.5-3b").reduced()
    cells = {}
    for kind in ("decode", "train"):
        shape = ShapeCfg(kind, 32, 8, kind)
        policy = shd.ShardingPolicy(fsdp=kind == "train")
        grad_sh = (shd.tree_shardings(abstract_params(build_model(cfg)), mesh, cfg, policy)
                   if kind == "train" else None)
        b = input_specs(cfg, shape, grad_shardings=grad_sh)
        params = shd.tree_shardings(b.arg_specs[0], mesh, cfg, policy)
        if kind == "train":
            in_sh = (params, shd.tree_shardings(b.arg_specs[1], mesh, cfg, policy),
                     NamedSharding(mesh, P()),
                     shd.named(mesh, shd.batch_specs(mesh, b.arg_specs[3], accum=True)))
            out_sh = (in_sh[0], in_sh[1], {"loss": NamedSharding(mesh, P()),
                                           "step": NamedSharding(mesh, P())})
        else:
            in_sh = (params, shd.named(mesh, shd.cache_specs(mesh, b.arg_specs[1], cfg, policy)),
                     shd.named(mesh, shd.batch_specs(mesh, b.arg_specs[2])))
            out_sh = (NamedSharding(mesh, P()), in_sh[1])
        with mesh, sc.activate(sc.from_mesh(mesh)):
            text = jax.jit(b.fn, in_shardings=in_sh, out_shardings=out_sh).lower(
                *b.arg_specs).compile().as_text()
        tr = hlo.collect(text, 8)
        cells[kind] = {"ops": op_walk(text),
                       "collect": {"counts": tr.counts, "wire_bytes": tr.wire_bytes}}
    out["cells"] = cells
    print("JAX_CASES " + json.dumps(out))
""")


# -- the port side, in its own process ---------------------------------------------------
def _collective_cases() -> dict:
    """(a) on the port: the four computations on meta tensors (the ring on
    real ones: ``batch_isend_irecv`` takes no meta tensor), counted."""
    import torch
    from torch.distributed.tensor import Replicate

    from repro_torch import sharding_ctx as sc
    from repro_torch.analysis.collectives import count_collectives
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import blocks
    from repro_torch.optim import compress
    mesh = device_mesh((2, 4), ("data", "model"), ranks=range(8), device="cpu")
    meta = torch.device("meta")

    def put(shape, spec, dtype=torch.float32):
        return shd.place(torch.empty(shape, dtype=dtype, device=meta),
                         shd.NamedSharding(mesh, shd.P(*spec)))

    out = {}
    B, D, F = 16, 64, 128
    bf = torch.bfloat16
    by_data = shd.to_placements(shd.P("data", None), mesh)
    out["tp_mlp"] = count_collectives(
        lambda x, w1, w2: (torch.relu(x @ w1) @ w2).redistribute(mesh, by_data),
        put((B, D), ("data", None), bf), put((D, F), (None, "model"), bf),
        put((F, D), ("model", None), bf), n_devices=8)
    out["fsdp_gather"] = count_collectives(
        lambda x, w: x @ w.redistribute(mesh, [Replicate(), Replicate()]),
        put((B, D), ("data", None)), put((D, F), ("data", None)), n_devices=8)

    cfg = get_config("llama4-scout-17b-a16e").reduced()
    cfg = dataclasses.replace(cfg, compute_dtype="float32", moe=dataclasses.replace(
        cfg.moe, top_k=2, n_experts=8, capacity_factor=2.0))
    layer = blocks.MoE(cfg, device=meta)
    policy = shd.ShardingPolicy(fsdp=False, ep_axis="data")
    shd.distribute_params(layer, {
        k: s if k.startswith("experts.") else shd.NamedSharding(mesh, shd.P())
        for k, s in shd.tree_shardings(layer, mesh, cfg, policy).items()})

    def moe(x):
        with sc.activate(sc.from_mesh(mesh, ep_data=True)):
            return layer.forward_sorted(x, impl="ref")
    out["moe"] = count_collectives(moe, put((8, 16, cfg.d_model), ("data", None, None)),
                                   n_devices=8)

    ring = device_mesh((8,), ("data",), ranks=range(8), device="cpu").get_group("data")
    out["ring"] = count_collectives(lambda r: compress.compressed_mean(r, ring, 8),
                                    torch.zeros(4096), n_devices=8)
    return {k: dataclasses.asdict(v) for k, v in out.items()}


FAMILIES = {"dense": "qwen2.5-3b", "mamba2": "mamba2-370m", "moe": "llama4-scout-17b-a16e",
            "hybrid": "jamba-1.5-large-398b", "encdec": "seamless-m4t-medium",
            "prefix": "internvl2-26b"}


def _spec_bytes(bundle, mesh, cfg, policy) -> int:
    """A device's argument bytes from the specs alone: each leaf's bytes
    with every dim divided, by ceiling, by the shards its spec gives."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import axis_sizes
    sizes = axis_sizes(mesh)

    def leaf(t, spec):
        n = t.element_size()
        for d, entry in zip(t.shape, tuple(spec) + (None,) * (t.ndim - len(spec))):
            axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
            n *= -(-d // math.prod(sizes[a] for a in axes))
        return n

    def added(x):
        if isinstance(x, dict):
            return sum(added(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return sum(added(v) for v in x)
        return x

    def total(tree, specs):
        return added(shd.tree_map(leaf, tree, specs))

    args = bundle.arg_specs
    params = dict(args[0].named_parameters())
    n = total(params, shd.tree_pspecs(args[0], mesh, cfg, policy))
    if bundle.kind == "train":
        _, opt_state, _, batch = args
        return (n + total(opt_state, shd.tree_pspecs(opt_state, mesh, cfg, policy))
                + total(batch, shd.batch_specs(mesh, batch, accum=True)))
    _, cache, tokens = args
    return (n + total(cache, shd.cache_specs(mesh, cache, cfg, policy))
            + total(tokens, shd.batch_specs(mesh, {"t": tokens})["t"]))


def _reduced_cells() -> dict:
    """(b) one reduced config a family, train and decode, at (2, 4)."""
    from repro_torch.analysis.step_cost import count_step
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import device_mesh
    mesh = device_mesh((2, 4), ("data", "model"), ranks=range(8), device="cpu")
    out = {}
    for family, arch in FAMILIES.items():
        cfg = get_config(arch).reduced()
        for kind in ("train", "decode"):
            shape = ShapeCfg(kind, 32, 8, kind)
            policy = shd.ShardingPolicy(fsdp=kind == "train")
            t0 = time.perf_counter()
            res = dryrun.dry_run(cfg, shape, mesh, policy, arch=arch, mesh_name="2x4")
            one = steps.input_specs(cfg, shape, impl="ref")
            out[family, kind] = {
                "result": res, "seconds": time.perf_counter() - t0,
                "flops_one": count_step(one.fn, *one.arg_specs).flops,
                "spec_bytes": _spec_bytes(steps.input_specs(cfg, shape, impl="ref"), mesh,
                                          cfg, policy)}
    return out


def _site() -> list:
    """The port's functions on the stack, innermost first; in a backward
    pass, those of the forward code that made the autograd node running
    (anomaly mode records its traceback)."""
    import re
    import traceback

    import torch
    node = torch._C._current_autograd_node()
    if node is not None:
        text = "".join(node.metadata.get("traceback_", []))
        frames = re.findall(r'File "[^"]*repro_torch/([^"]*)", line \d+, in (\w+)', text)
    else:
        frames = [(f.filename.split("repro_torch/")[-1], f.name)
                  for f in traceback.extract_stack() if "repro_torch/" in f.filename]
    return [f"{path}:{fn}" for path, fn in frames[::-1] if "analysis/" not in path]


def _whole_cells() -> dict:
    """The reduced qwen2.5-3b decode and train cells at (2, 4) through
    `dryrun.dry_run`, each collective recorded with its kind, result
    size, group and the code that issued it (the JAX side compiles the
    same cells)."""
    import torch

    from repro_torch.analysis import collectives
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import device_mesh
    ops = []

    class Sites(collectives._Counter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = dict(self.stats.counts)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and self.stats.counts != before:
                kind, where = collectives.OPS[func._schema.name]
                ts = collectives._tensors(out if where == "out" else args[where])
                ops.append({"kind": kind, "numel": sum(t.numel() for t in ts),
                            "bytes": sum(t.numel() * t.element_size() for t in ts),
                            "g": collectives._group_size(func, args), "site": _site()})
            return out

    mesh = device_mesh((2, 4), ("data", "model"), ranks=range(8), device="cpu")
    cfg = get_config("qwen2.5-3b").reduced()
    counter, collectives._Counter = collectives._Counter, Sites
    out = {}
    try:
        with torch.autograd.set_detect_anomaly(True, check_nan=False):
            for kind in ("decode", "train"):
                ops.clear()
                res = dryrun.dry_run(cfg, ShapeCfg(kind, 32, 8, kind), mesh,
                                     shd.ShardingPolicy(fsdp=kind == "train"), mesh_name="2x4")
                out[kind] = {"ops": list(ops), "collectives": res["roofline"]["collectives"]}
    finally:
        collectives._Counter = counter
    return out


def _production() -> dict:
    """(c) qwen2.5-3b decode_32k at 16x16, and its argument bytes from the
    specs under the cell's policy."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import device_mesh
    res = dryrun.run_cell("qwen2.5-3b", "decode_32k", save=False, verbose=False)
    cfg = get_config("qwen2.5-3b")
    mesh = device_mesh((16, 16), ("data", "model"), ranks=range(256), device="cpu")
    spec = _spec_bytes(steps.input_specs(cfg, SHAPES["decode_32k"], impl="ref"), mesh, cfg,
                       shd.ShardingPolicy(fsdp=False))
    return {"result": res, "spec_bytes": spec}


def _port_side(path: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    dryrun.join_fake_group(256)
    out = {"cases": _collective_cases(), "cells": _reduced_cells(),
           "whole": _whole_cells(), "production": _production()}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k", "--no-save"])
    out["cli"] = buf.getvalue()
    dist.destroy_process_group()
    with open(path, "wb") as fh:
        pickle.dump(out, fh)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    import json
    path = tmp_path_factory.mktemp("dryrun") / "port.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    child = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT / 'tests')!r}]; "
             f"import test_torch_dryrun as t; t._port_side({str(path)!r})")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for code in (child, _JAX_CASES)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, (so[-2000:], se[-4000:])
    with open(path, "rb") as fh:
        port = pickle.load(fh)
    line = next(ln for ln in outs[1][0].splitlines() if ln.startswith("JAX_CASES "))
    return {"port": port, "jax": json.loads(line[len("JAX_CASES "):])}


# -- (a) ------------------------------------------------------------------------------------
def test_tp_mlp_all_reduce_is_jax_s_in_elements(sides):
    """One all-reduce over "model" of the (8, 64) result; XLA's CPU
    partitioner reduces the bf16 partial in float32 (class 3), so the
    port's bytes are half of JAX's: equal in elements."""
    got, want = sides["port"]["cases"]["tp_mlp"], sides["jax"]["tp_mlp"]["parse"]
    assert got["counts"] == want["counts"] == {"all-reduce": 1}
    assert got["op_bytes"]["all-reduce"] / 2 == want["op_bytes"]["all-reduce"] / 4
    assert got["wire_bytes"]["all-reduce"] / 2 == want["wire_bytes"]["all-reduce"] / 4
    assert sides["jax"]["tp_mlp"]["collect"]["wire_bytes"] == want["wire_bytes"]


def test_fsdp_gather_is_jax_s(sides):
    got, want = sides["port"]["cases"]["fsdp_gather"], sides["jax"]["fsdp_gather"]["parse"]
    assert got == want
    assert got["counts"] == {"all-gather": 1}
    assert got["wire_bytes"]["all-gather"] == 0.5 * got["op_bytes"]["all-gather"]    # g = 2


def test_moe_all_to_all_is_jax_s_and_sums_by_class(sides):
    """The four all-to-alls (two a round) equal; the two rounds' within-
    expert sums are JAX's one combined all-reduce (class 4); the shared
    expert's down projection, its hidden split over "model", ends in an
    all-reduce of the partial result where XLA gathers the hidden first,
    the same bytes (class 5)."""
    got, want = sides["port"]["cases"]["moe"], sides["jax"]["moe"]["parse"]
    for key in ("op_bytes", "wire_bytes", "counts"):
        assert got[key]["all-to-all"] == want[key]["all-to-all"]
    assert set(got["counts"]) == {"all-to-all", "all-reduce"}
    assert set(want["counts"]) == {"all-to-all", "all-reduce", "all-gather"}
    assert got["counts"]["all-reduce"] == want["counts"]["all-reduce"] + 1 \
        + want["counts"]["all-gather"]
    assert got["op_bytes"]["all-reduce"] == want["op_bytes"]["all-reduce"] \
        + want["op_bytes"]["all-gather"]
    assert got["wire_bytes"]["all-reduce"] == want["wire_bytes"]["all-reduce"] \
        + 2 * want["wire_bytes"]["all-gather"]
    assert sides["jax"]["moe"]["collect"]["wire_bytes"] == want["wire_bytes"]


def test_ring_permutes_are_jax_s_with_its_trip_counts(sides):
    """2 x 7 hops of (q, scale), each a permute: ``hlo.collect`` multiplies
    the loop bodies' permutes by their trip counts; the eager ring issues
    every hop."""
    got, want = sides["port"]["cases"]["ring"], sides["jax"]["ring"]["collect"]
    assert got["counts"] == {"collective-permute": 28}
    assert got["counts"]["collective-permute"] == want["counts"]["collective-permute"]
    assert got["wire_bytes"] == want["wire_bytes"]
    assert got["op_bytes"] == got["wire_bytes"]


# -- (a) whole cells: the reduced qwen2.5-3b decode and train steps -------------------------
# Each collective of a step goes to the role it plays there.  Where both
# sides run the same algorithm the role is held equal (in elements: XLA's
# CPU backend moves bf16 collectives as float32, class 3); every other
# role is one of the classes `analysis.collectives` names.
HELD = {"decode": "tp_sum", "train": "fsdp_gather"}
ROLES = {"decode": {"port": {"embed", "cache", "tp_sum"},
                    "jax": {"embed", "cache", "tp_sum", "output"}},
         "train": {"port": {"embed", "fsdp_gather", "head", "heads", "tp_sum", "loss", "sums"},
                   "jax": {"embed", "fsdp_gather", "head", "heads", "tp_sum", "loss", "sums"}}}


def _port_role(cell, op):
    fns = {s.split(":")[-1] for s in op["site"]}
    if "lookup" in fns:
        return "embed"                       # the table gathered whole (class 7)
    if cell == "decode":
        if fns & {"decode_attention", "heads"}:
            return "cache"                   # the split cache gathered whole (class 6)
        return "tp_sum" if "pin" in fns else "?"
    if fns & {"heads", "merge_heads", "attention"}:
        return "heads"
    if "_chunk_nll" in fns:                  # the head's weight over "data", its logits over "model"
        return "head" if op["g"] == 2 else "loss"
    if fns & {"pin", "rmsnorm"}:
        return "tp_sum"
    if op["kind"] == "all-gather" and op["g"] == 2 and fns & {"_qkv", "_ffn", "forward"}:
        return "fsdp_gather"
    if fns & {"train_step", "global_norm", "chunked_lm_loss"}:
        return "sums"                        # gradients to their layout, the norm, the loss
    return "?"


def _jax_role(cell, op):
    name = op["op_name"]
    last = name.split("/")[-1]
    if not name:
        return "output"                      # the jit's out_shardings (class 9)
    if "_take" in name:
        return "embed"
    if cell == "decode":
        return "tp_sum" if name.endswith("closed_call/dot_general") else "cache"
    if op["kind"] == "all-gather" and op["g"] == 2 and last == "dot_general":
        return "fsdp_gather" if "/while/" in name else "head"
    if op["kind"] == "all-reduce" and last == "dot_general":
        return "tp_sum"
    if "rematted_computation" in name:
        return "loss"
    if "/checkpoint/while/" in name or last != "reduce_sum":
        return "heads"
    return "sums"


def _roles(sides, cell):
    """{side: {role: {"counts", "numel", "bytes", "wire"} by kind}}; each
    JAX op times its loop's trips, each port op once."""
    from repro_torch.analysis.collectives import RING
    out = {"port": {}, "jax": {}}
    for side, ops, role in (("port", sides["port"]["whole"][cell]["ops"], _port_role),
                            ("jax", sides["jax"]["cells"][cell]["ops"], _jax_role)):
        for op in ops:
            mult = op.get("mult", 1.0)
            r = out[side].setdefault(role(cell, op), {}).setdefault(
                op["kind"], {"counts": 0.0, "numel": 0.0, "bytes": 0.0, "wire": 0.0})
            r["counts"] += mult
            r["numel"] += op["numel"] * mult
            r["bytes"] += op["bytes"] * mult
            r["wire"] += RING[op["kind"]](op["bytes"], op["g"]) * 8 * mult
    return out


@pytest.mark.parametrize("cell", ["decode", "train"])
def test_whole_cell_is_jax_s_up_to_named_classes(sides, cell):
    """Every collective of the step falls in a role; the role both sides
    run alike is equal in kinds, counts and elements; the op-by-op sums
    are the totals `count_collectives` and ``hlo.collect`` give."""
    roles = _roles(sides, cell)
    for side, key, total in (("port", "collectives", sides["port"]["whole"][cell]["collectives"]),
                             ("jax", "collect", sides["jax"]["cells"][cell]["collect"])):
        kinds = {}
        for by_kind in roles[side].values():
            for kind, r in by_kind.items():
                kinds[kind] = kinds.get(kind, 0.0) + r["wire"]
        assert kinds == pytest.approx(total["wire_bytes"], rel=1e-12), (side, key)
        assert set(roles[side]) == ROLES[cell][side], side
    port, jax_ = roles["port"][HELD[cell]], roles["jax"][HELD[cell]]
    assert set(port) == set(jax_) and len(port) == 1
    for kind in port:
        assert port[kind]["counts"] == jax_[kind]["counts"] > 0
        assert port[kind]["numel"] == jax_[kind]["numel"]
        assert 2 * port[kind]["bytes"] == jax_[kind]["bytes"]          # class 3


def test_whole_cells_named_classes(sides):
    """The classes the whole cells show, each as the port and XLA run it:
    the embedding (the port gathers the table, XLA sums looked-up rows),
    the split cache (the port gathers it, XLA reduces softmax statistics),
    the loss over split logits (gathered, or reduced statistics) and the
    decode logits' output layout (JAX's out_shardings gather them)."""
    dec, tr = _roles(sides, "decode"), _roles(sides, "train")
    assert set(dec["port"]["embed"]) == {"all-gather"}
    assert "all-reduce" in dec["jax"]["embed"] and "all-gather" not in dec["jax"]["embed"]
    assert dec["port"]["embed"]["all-gather"]["wire"] > 5 * dec["jax"]["embed"]["all-reduce"]["wire"]
    assert set(tr["port"]["embed"]) == {"all-gather", "reduce-scatter"}
    assert set(dec["port"]["cache"]) == {"all-gather"}
    assert "all-reduce" in dec["jax"]["cache"]
    assert set(tr["port"]["loss"]) == {"all-gather"} and set(tr["jax"]["loss"]) == {"all-reduce"}
    assert set(dec["jax"]["output"]) == {"all-gather"}
    assert "reduce-scatter" in tr["port"]["sums"] and "reduce-scatter" not in tr["jax"]["sums"]


# -- (b), (c), (d) --------------------------------------------------------------------------
def _jax_keys() -> dict:
    from repro.analysis.roofline import RooflineReport
    return {"": {"arch", "shape", "mesh", "variant", "knobs", "kind", "n_devices", "lower_s",
                 "compile_s", "memory", "roofline", "policy"},
            "knobs": {"tp", "sp", "accum", "fsdp", "ep_axis", "moe_impl"},
            "memory": {"argument_size", "output_size", "temp_size", "generated_code_size"},
            "roofline": {f.name for f in dataclasses.fields(RooflineReport)},
            "policy": {"fsdp", "tp", "seq_shard_cache"}}


def _check_keys(res):
    for key, want in _jax_keys().items():
        assert set(res[key] if key else res) == want, key


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_reduced_cell_on_a_fake_mesh(sides, family, kind):
    cell = sides["port"]["cells"][family, kind]
    res, roof = cell["result"], cell["result"]["roofline"]
    _check_keys(res)
    assert res["kind"] == kind and res["n_devices"] == 8 and res["mesh"] == "2x4"
    assert roof["hlo_flops"] == cell["flops_one"] > 0
    assert res["memory"]["argument_size"] == cell["spec_bytes"]
    assert res["memory"]["output_size"] > 0 and res["memory"]["temp_size"] is None
    assert roof["per_device_peak_memory"] == res["memory"]["argument_size"]
    assert roof["collective_s"] > 0 and roof["wire_bytes"] == sum(
        roof["collectives"]["wire_bytes"].values())
    assert roof["collective_s"] == pytest.approx(roof["wire_bytes"] / (8 * 450e9), rel=1e-12)
    if kind == "train":      # FSDP: the weights gathered, their gradients scattered
        assert {"all-gather", "reduce-scatter"} <= set(roof["collectives"]["counts"])


def test_qwen_decode_at_16x16_splits_kv_heads_inside_a_head(sides):
    """2 kv heads of 128 over a model axis of 16: the K/V projections are
    gathered over "model" before the head view (where DTensor refused the
    view before), the cache is split over its capacity."""
    prod = sides["port"]["production"]
    res = prod["result"]
    _check_keys(res)
    assert (res["mesh"], res["n_devices"], res["kind"]) == ("16x16", 256, "decode")
    assert res["memory"]["argument_size"] == prod["spec_bytes"]
    assert res["roofline"]["collective_s"] > 0
    assert all(math.isfinite(res["roofline"][k]) for k in ("compute_s", "memory_s"))


def test_cli_runs_a_cell(sides):
    out = sides["port"]["cli"]
    assert "[OK] mamba2-370m x decode_32k x 16x16" in out
    assert "all dry-run cells ran" in out and "[FAIL]" not in out
