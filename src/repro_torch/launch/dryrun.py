"""The multi-pod dry run: every (arch x shape x mesh) cell's step placed on
the production mesh and run once, with its memory, counts, collectives
and roofline; ported from ``repro/launch/dryrun.py``.

The JAX script lowers and compiles each cell on 512 fake host devices.
The port has no compiler to ask, so one process stands in for every rank
of a fake process group (``torch.testing._internal.distributed.fake_pg``:
the ``"fake"`` backend, whose collectives move nothing) of 256 or 512
ranks, builds the ("pod",)? "data" "model" ``DeviceMesh`` on it, places
the cell's abstract arguments (``meta`` tensors: shapes and dtypes, no
storage) by the JAX partition specs as DTensors, and runs the step once
as rank 0.  This runs on the host by design, as the JAX dry run does: it
allocates nothing on any device.

Per cell: the argument bytes a device holds (rank 0's local shards; the
counterpart of ``argument_size_in_bytes``) and its outputs' bytes, the
global FLOPs and bytes of the unplaced step (`step_cost.count_step`, as
JAX counts the unsharded function), the collectives the meshed step
issued (`collectives.count_collectives`), and the three-term roofline on
`HW_H100` (`roofline.analyze_step`).  ``lower_s`` is the seconds taken to
place and run the meta step; there is no compile (``compile_s`` 0.0) and
no compiled program, so ``temp_size`` and ``generated_code_size`` are
None.  Results go to ``artifacts/dryrun_torch/``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --no-save
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch jamba-1.5-large-398b \\
        --shape long_500k --multi-pod
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from dataclasses import replace
from pathlib import Path

import torch

from .. import sharding_ctx as sc
from ..analysis.collectives import count_collectives
from ..analysis.roofline import HW_H100, analyze_step
from ..analysis.step_cost import count_step
from ..configs import SHAPES, all_cells, get_config
from ..models import blocks
from . import sharding as shd
from .mesh import axis_sizes, device_mesh, mesh_device_count, production_shape
from .steps import input_specs

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def join_fake_group(world: int) -> None:
    """Make this process rank 0 of a fake default group of ``world`` ranks
    (no rendezvous, collectives that move nothing); a default group of
    that size is kept, one of another size refused."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"the dry run needs a world of {world} ranks; the default "
                               f"group has {dist.get_world_size()}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def place_args(kind: str, args: tuple, mesh, cfg, policy) -> tuple:
    """A step's arguments (`steps.input_specs`'s, on any device) placed as
    the JAX ``_shardings_for`` lays them out: parameters (in place) and
    optimizer state by the rules, the batch over the data axes
    (accumulation index first to train), the cache by `cache_specs`."""
    def put(tree, specs):
        return shd.tree_map(lambda t, s: shd.place(t, shd.NamedSharding(mesh, s)), tree, specs)

    params = shd.distribute_params(args[0], shd.tree_shardings(args[0], mesh, cfg, policy))
    if kind == "train":
        _, opt_state, step, batch = args
        opt_state = put(opt_state, shd.tree_pspecs(opt_state, mesh, cfg, policy))
        return params, opt_state, step, put(batch, shd.batch_specs(mesh, batch, accum=True))
    if kind == "prefill":
        return params, put(args[1], shd.batch_specs(mesh, args[1]))
    _, cache, tokens = args
    return (params, put(cache, shd.cache_specs(mesh, cache, cfg, policy)),
            put(tokens, shd.batch_specs(mesh, {"t": tokens})["t"]))


def local_bytes(tree) -> int:
    """The bytes of this rank's shards of every tensor in ``tree`` (an
    `LM`'s parameters, dicts, lists, tuples); a plain tensor counts whole,
    anything else nothing."""
    if isinstance(tree, torch.nn.Module):
        return sum(local_bytes(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    return 0


def dry_run(cfg, shape, mesh, policy, *, arch: str | None = None, mesh_name: str = "",
            sp: bool = False, variant: str = "") -> dict:
    """One cell at ``cfg`` (a config, reduced or not), ``shape``, on
    ``mesh`` (a ``DeviceMesh`` of this world) under ``policy``, the MoE
    dispatch `blocks.set_moe_impl` chose: the JAX result dict."""
    t0 = time.time()
    bundle = input_specs(cfg, shape, impl="ref")
    placed = place_args(bundle.kind, bundle.arg_specs, mesh, cfg, policy)
    n_dev = mesh_device_count(mesh)
    outputs = []

    def step(*args):
        with sc.activate(sc.from_mesh(mesh, sp=sp, ep_data=policy.ep_axis == "data")):
            outputs.append(bundle.fn(*args))

    coll = count_collectives(step, *placed, n_devices=n_dev)
    t_lower = time.time() - t0
    if bundle.kind == "train":       # JAX's step returns what the port's updates in place
        outputs = [(placed[0], placed[1], outputs[0])]
    unplaced = input_specs(cfg, shape, impl="ref")
    cost = count_step(unplaced.fn, *unplaced.arg_specs)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    arg_bytes = local_bytes(placed)
    rep = analyze_step(arch=arch or cfg.name, shape_name=shape.name, kind=shape.kind, cfg=cfg,
                       tokens=tokens, step_flops=cost.flops, step_bytes=cost.major_bytes,
                       hw=HW_H100, n_devices=n_dev, mesh_name=mesh_name, collectives=coll,
                       per_device_peak_memory=float(arg_bytes))
    rep.note += ("; no compiled program: memory.temp_size and generated_code_size are None, "
                 "argument_size and output_size are rank 0's local shards, and "
                 "per_device_peak_memory is argument_size alone (JAX adds temp_size: "
                 "here a lower bound)")
    return {
        "arch": arch or cfg.name, "shape": shape.name, "mesh": mesh_name,
        "variant": variant or "baseline",
        "knobs": {"tp": axis_sizes(mesh)["model"], "sp": sp, "accum": cfg.grad_accum, "fsdp": policy.fsdp,
                  "ep_axis": policy.ep_axis, "moe_impl": blocks.MOE_IMPL},
        "kind": bundle.kind, "n_devices": n_dev,
        "lower_s": round(t_lower, 1), "compile_s": 0.0,
        "memory": {"argument_size": arg_bytes, "output_size": local_bytes(outputs),
                   "temp_size": None, "generated_code_size": None},
        "roofline": json.loads(rep.to_json()),
        "policy": {"fsdp": policy.fsdp, "tp": policy.tp,
                   "seq_shard_cache": policy.seq_shard_cache},
    }


def _mesh_name(mesh, multi_pod: bool, tp: int | None, rep: int | None) -> str:
    if rep:
        return "x".join(str(x) for x in mesh.mesh.shape)
    if tp in (None, 16):
        return "2x16x16" if multi_pod else "16x16"
    return "2x%dx%d" % (256 // tp, tp) if multi_pod else "%dx%d" % (256 // tp, tp)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, save: bool = True,
             policy: shd.ShardingPolicy | None = None, verbose: bool = True,
             tp: int | None = None, sp: bool = False, accum: int | None = None,
             fsdp: bool | None = None, param_dtype: str | None = None,
             ep_axis: str = "model", moe_impl: str = "einsum", rep: int | None = None,
             variant: str = "") -> dict:
    """Dry-run one cell of the production mesh.  The default group must be
    a world of the mesh's size or more (`join_fake_group`).

    Variant knobs (defaults = the baseline policy), as in the JAX script:
      tp      — model-axis width; a pod reshapes to (256 // tp, tp)
      sp      — Megatron-style sequence parallelism on the residual stream
      accum   — gradient-accumulation override (microbatch size lever)
      fsdp    — force FSDP on/off
      variant — artifact-name suffix so baselines are never overwritten
    """
    cfg = get_config(arch)
    if accum is not None:
        cfg = replace(cfg, grad_accum=accum)
    if param_dtype is not None:
        cfg = replace(cfg, param_dtype=param_dtype)
    shape = SHAPES[shape_name]
    spec = production_shape(multi_pod=multi_pod, tp=tp, rep=rep)
    mesh = device_mesh(spec.sizes, spec.axis_names, ranks=range(mesh_device_count(spec)),
                       device="cpu")
    if policy is None:
        policy = shd.ShardingPolicy(
            fsdp=(shape.kind == "train") if fsdp is None else fsdp,
            seq_shard_cache=(shape.name == "long_500k"), ep_axis=ep_axis)
    old_impl = blocks.MOE_IMPL
    blocks.set_moe_impl(moe_impl)
    try:
        result = dry_run(cfg, shape, mesh, policy, arch=arch,
                         mesh_name=_mesh_name(mesh, multi_pod, tp, rep), sp=sp, variant=variant)
    finally:
        blocks.set_moe_impl(old_impl)
    if verbose:
        r, arg_gb = result["roofline"], result["memory"]["argument_size"] / 1e9
        print(f"[OK] {arch} x {shape_name} x {result['mesh']}: "
              f"lower {result['lower_s']:.0f}s compile 0s | "
              f"args {arg_gb:.1f}GB temp n/a (a device) | "
              f"flops {r['hlo_flops']:.3g} wire {r['wire_bytes']:.3g}B | "
              f"bottleneck={r['bottleneck']} "
              f"terms(c/m/n)={r['compute_s']:.3f}/{r['memory_s']:.3f}/"
              f"{r['collective_s']:.3f}s")
        print(json.dumps(result), flush=True)
    if save:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        suffix = f"__{variant}" if variant else ""
        out = ART_DIR / f"{arch}__{shape_name}__{result['mesh']}{suffix}.json"
        out.write_text(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--param-dtype", default=None)
    ap.add_argument("--ep-axis", default="model", choices=["model", "data"])
    ap.add_argument("--moe-impl", default="einsum", choices=["einsum", "sorted"])
    ap.add_argument("--rep", type=int, default=None)
    ap.add_argument("--variant", default="")
    args = ap.parse_args(argv)

    cells = [(a, s, ok, why) for (a, s, ok, why) in all_cells()
             if (args.arch is None or a == args.arch)
             and (args.shape is None or s == args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    join_fake_group(512 if True in meshes else 256)
    failures = []
    for arch, shape_name, ok, why in cells:
        if not ok:
            print(f"[SKIP] {arch} x {shape_name}: {why}")
            continue
        for mp in meshes:
            try:
                run_cell(arch, shape_name, multi_pod=mp, save=not args.no_save,
                         tp=args.tp, sp=args.sp, accum=args.accum,
                         fsdp=None if args.fsdp is None else args.fsdp == "on",
                         param_dtype=args.param_dtype, ep_axis=args.ep_axis,
                         moe_impl=args.moe_impl, rep=args.rep, variant=args.variant)
            except Exception as e:  # a failing cell is a bug in the system
                failures.append((arch, shape_name, mp, repr(e)))
                print(f"[FAIL] {arch} x {shape_name} multi_pod={mp}: {e}")
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: {failures}")
    print("all dry-run cells ran")


if __name__ == "__main__":
    main()
