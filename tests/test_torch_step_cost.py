"""The port's abstract step (`launch.steps`) and its count
(`analysis.step_cost`, `analysis.roofline.analyze_step`) against the JAX
package's (``repro.launch.steps``, ``repro.analysis.jaxpr_cost``).

  * ``configs.all_cells`` equals the JAX registry's.
  * At full size, for every architecture: `abstract_params` (an `LM` on
    the meta device) has the names, shapes and dtypes of JAX
    ``abstract_params(build_model(cfg))`` unstacked by the bridge's
    flattening; `abstract_cache` those of JAX ``abstract_cache`` on every
    decode cell; `abstract_opt_state` those of JAX
    ``abstract_opt_state`` on every train cell (AdamW's two moments,
    Adafactor's factored ones); `batch_struct` those of JAX
    ``batch_struct`` on every cell.
  * ``count_step`` of each reduced config's train, prefill and decode
    step (B 2, S 64, both ``impl="ref"``) against JAX ``count_step``.
    FLOPs equal to 1e-9 relative on every config, once the op classes
    where the two lower the same function differently are taken out,
    each by a count of its own:
      - the outer products: JAX lowers an einsum term that sums no index
        (Mamba2's ``"bh,bn,bhp->bhpn"``) to a ``dot_general``, PyTorch
        to a multiplication, which is no product (the SSD oracle's and
        the decode step's; to train, also their transposes in the
        backward).  Held: the step's difference equals the Mamba layers'
        count of the SSD oracle alone (JAX less port, through ``jax.vjp``
        and autograd at the layer's shapes) and, to decode, JAX's outer
        products;
      - the MoE dispatch: JAX dispatches and combines by one-hot einsums
        (``blocks.py:371`` and ``:375``, 2 B S E C D FLOPs each, a
        round), the port by index; to train, JAX also differentiates
        them (three more products a round: the dispatch's input, the
        combine's two);
      - the attention oracle's recomputation: JAX's (``ref.mha_chunked``)
        is a ``jax.checkpoint`` and runs its forward again in the
        backward, the port's (``ref.mha_reference``) keeps its logits.
        Held: to train, the port's step with its oracle under
        ``torch.utils.checkpoint`` (the same recomputation) is the step
        compared, and it exceeds the port's own step by one forward of
        the oracle per attention layer (4 B H S S D FLOPs, on the
        decoders with one self-attention a layer).
    Major bytes: the embedding table's gather equal everywhere; the
    matrix products' equal on every config without Mamba2 or MoE layers
    (the named classes move them too).  Named where they differ: the MoE
    dispatch (JAX's einsum products; the port's ``index_add``,
    ``index_select`` and its routing's ``gather`` and ``scatter``); to
    train, the loss's ``gather``, which the port's checkpointed chunk runs
    again in its backward, on int64 indices, and JAX's remat does not;
    the backward's ``scatter_add`` and ``index_put`` (the JAX count names
    ``scatter-add``, which this JAX lowers as ``scatter_add``, so it
    counts none); JAX's ``dynamic_slice``, a view in the port; and the
    decode step's slot write, JAX's ``dynamic_update_slice`` (four int32
    start indices) against the port's ``index_copy_`` (one int64 slot).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import jaxpr_cost
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import all_cells as jax_all_cells
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCfg as JaxShapeCfg
from repro.kernels import ref as jax_ref
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.analysis import HW_H100, analyze_step, count_step
from repro_torch.configs import ARCHS, SHAPES, all_cells, get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.optim import cosine_schedule, get_optimizer

META = torch.device("meta")
REL = 1e-9
KINDS = ("train", "prefill", "decode")
SMALL = {k: ShapeCfg(k, 64, 2, k) for k in KINDS}


def _dtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int32": torch.int32}[str(name)]


def _arrays(tree):
    """A JAX abstract tree as zero-strided numpy arrays of its shapes and
    dtypes (no storage), so the bridge can index its stacked leaves."""
    return jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), tree)


def _described(flat: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in flat.items()}


def test_all_cells_equal_jax():
    assert ARCHS == tuple(JAX_ARCHS) and len(ARCHS) == 10
    assert all_cells() == jax_all_cells()
    assert SHAPES.keys() == {"train_4k", "prefill_32k", "decode_32k", "long_500k"}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_jax(arch):
    """Full size, on the meta device: every name, shape and dtype of the
    JAX abstract parameters, unstacked by the bridge; nothing allocated."""
    cfg = get_config(arch)
    jparams = jax_steps.abstract_params(jax_build_model(jax_get_config(arch)))
    want = _described(bridge._flat_jax(cfg, _arrays(jparams)))
    params = steps.abstract_params(cfg)
    got = _described(dict(params.named_parameters()))
    assert got == want
    assert all(p.is_meta for p in params.parameters())
    assert sum(p.numel() for p in params.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(jparams))
    serving = steps.abstract_params(cfg, serving=True)
    assert serving.head is None or serving.head.dtype == torch.bfloat16


def _decode_cells():
    return [(a, s) for a, s, ok, _ in all_cells() if ok and SHAPES[s].kind == "decode"]


@pytest.mark.parametrize("arch,shape", _decode_cells())
def test_abstract_cache_matches_jax(arch, shape):
    """Every layer's cache of the cell, unstacked from JAX's periods; the
    port's encoder-decoder cache also holds ``cross_len``, a () int32."""
    cfg, jcfg, sh = get_config(arch), jax_get_config(arch), SHAPES[shape]
    jc = jax_steps.abstract_cache(jax_build_model(jcfg), jcfg, JaxShapeCfg(**vars(sh)))
    cache = steps.abstract_cache(cfg, sh)
    n = len(cfg.block_pattern)
    want = {"pos": ((), "int32")}
    for i in range(cfg.n_layers):
        for leaf, s in bridge.flat_tree(jc["layers"][f"pos{i % n}"]).items():
            want[f"layers.{i}.{leaf}"] = (tuple(s.shape[1:]), str(s.dtype))
    got = {"pos": ((), "int32")}
    for i, c in enumerate(cache["layers"]):
        for leaf, t in bridge.flat_tree(c).items():
            got[f"layers.{i}.{leaf}"] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    assert got == want
    assert str(jc["pos"].dtype) == "int32" and cache["pos"].dtype == torch.int32
    assert set(cache) == ({"pos", "layers", "cross_len"} if cfg.encdec else {"pos", "layers"})


def _train_cells():
    return [(a, s) for a, s, ok, _ in all_cells() if ok and SHAPES[s].kind == "train"]


def _flat_state(cfg, state):
    """{moment.param: leaf}: JAX's AdamW {"m", "v"} trees and Adafactor's
    {"f": {param: {"vr", "vc"} or {"v"}}} under the port's names."""
    out = {}
    for key, tree in state.items():
        top = ("embed", "final_norm", "head", "enc_norm")
        layers = bridge._flat_jax(cfg, {**tree, **dict.fromkeys(top)})
        named = {**{k: v for k, v in layers.items() if v is not None},
                 **bridge.flat_tree({k: tree[k] for k in top if k in tree})}
        out.update({f"{key}.{name}": leaf for name, leaf in named.items()})
    return out


@pytest.mark.parametrize("arch,shape", _train_cells())
def test_abstract_opt_state_matches_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    _, jopt, _ = jax_steps.make_train_step(jcfg)
    jstate = jax_steps.abstract_opt_state(jopt, jax_steps.abstract_params(
        jax_build_model(jcfg)))
    opt = get_optimizer(cfg.optimizer, cosine_schedule(3e-4, 2000, 100_000), cfg=cfg)
    state = steps.abstract_opt_state(opt, steps.abstract_params(cfg))
    if cfg.optimizer == "adafactor":
        want = _flat_state(cfg, {"f": _arrays(jstate["f"])})
        got = {f"f.{k}.{m}": t for k, d in state["f"].items() for m, t in d.items()}
    else:
        want = _flat_state(cfg, {k: _arrays(v) for k, v in jstate.items()})
        got = {f"{m}.{k}": t for m, d in state.items() for k, t in d.items()}
    assert _described(got) == _described(want)
    assert all(t.is_meta for t in got.values())


@pytest.mark.parametrize("cell", [(a, s) for a, s, ok, _ in all_cells() if ok])
def test_batch_struct_matches_jax(cell):
    arch, shape = cell
    cfg, jcfg, sh = get_config(arch), jax_get_config(arch), SHAPES[shape]
    accum = cfg.grad_accum if sh.kind == "train" else None
    want = jax_steps.batch_struct(jcfg, JaxShapeCfg(**vars(sh)), accum=accum)
    got = steps.batch_struct(cfg, sh, accum=accum)
    assert {k: (tuple(v.shape), _dtype(v.dtype)) for k, v in want.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in got.items()}
    assert all(v.is_meta for v in got.values())


# -- the counts ------------------------------------------------------------------
def _jax_count(fn, *specs, table=None) -> dict:
    """JAX ``count_step``'s walk, split: {"contracting", "outer"} FLOPs
    (``dot_general`` with and without summed dimensions) and bytes by
    primitive (a gather from the embedding table, of shape ``table``, as
    ``"embed_gather"``), each total checked against ``count_step``'s."""
    out = {"contracting": 0.0, "outer": 0.0, "bytes": {}}
    jaxpr = jax.make_jaxpr(fn)(*specs).jaxpr

    def walk(j, mult):
        for eqn in j.eqns:
            subs = jaxpr_cost._sub_jaxprs(eqn)
            if subs:
                for sub, m in subs:
                    walk(sub, mult * m)
                continue
            prim = eqn.primitive.name
            if prim == "dot_general":
                (lc, _), _ = eqn.params["dimension_numbers"]
                out["contracting" if lc else "outer"] += mult * jaxpr_cost._dot_flops(eqn)
                prim = "dot_general" if lc else "outer"
            if prim == "gather" and eqn.invars[0].aval.shape == table:
                prim = "embed_gather"
            if prim in jaxpr_cost._MAJOR or prim in ("outer", "embed_gather"):
                nb = (sum(jaxpr_cost._nbytes(v.aval) for v in eqn.invars if hasattr(v, "aval"))
                      + sum(jaxpr_cost._nbytes(v.aval) for v in eqn.outvars))
                out["bytes"][prim] = out["bytes"].get(prim, 0.0) + mult * nb
    walk(jaxpr, 1.0)
    total = jaxpr_cost.count_step(fn, *specs)
    assert total.flops == pytest.approx(out["contracting"] + out["outer"], rel=REL)
    assert total.major_bytes == pytest.approx(sum(out["bytes"].values()), rel=REL)
    return out


def _port_classes(cost) -> dict:
    by = cost.by_op
    products = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::mv",
                "aten::dot")
    return {"flops": sum(by.get(k, (0, 0))[0] for k in products),
            "product_bytes": sum(by.get(k, (0, 0))[1] for k in products),
            "gather_bytes": sum(by.get(k, (0, 0))[1] for k in ("aten::index.Tensor",
                                                                "aten::index_select")),
            "ops": set(by)}


def _ssd_difference(cfg, jcfg, kind, B, L) -> float:
    """JAX less port FLOPs of one Mamba layer's SSD oracle at its shapes:
    ``ssd_chunked`` (prefill; with its vjp on every input, to train) or
    ``ssd_decode_step`` (decode)."""
    m = cfg.mamba
    H, P, N = m.n_ssm_heads(cfg.d_model), m.head_dim, m.d_state
    dt = cfg.compute_dtype
    shapes = ([(B, 1, H, P), (B, 1, H), (H,), (B, 1, N), (B, 1, N)] if kind == "decode"
              else [(B, L, H, P), (B, L, H), (H,), (B, L, N), (B, L, N)])
    dtypes = [dt, "float32", "float32", dt, dt]
    jspecs = [jax.ShapeDtypeStruct(s, jnp.dtype(d)) for s, d in zip(shapes, dtypes)]
    targs = [torch.empty(s, dtype=_dtype(d), device=META) for s, d in zip(shapes, dtypes)]
    if kind == "decode":
        state = (B, H, P, N)
        j = _jax_count(lambda s, x, d_, a, b, c: jax_ref.ssd_decode_step(
            s, x[:, 0], d_[:, 0], a, b[:, 0], c[:, 0]),
            jax.ShapeDtypeStruct(state, jnp.float32), *jspecs)
        p = count_step(lambda s, x, d_, a, b, c: ref.ssd_decode_step(
            s, x[:, 0], d_[:, 0], a, b[:, 0], c[:, 0]),
            torch.empty(state, device=META), *targs)
        return j["contracting"] + j["outer"] - p.flops
    if kind == "prefill":
        j = _jax_count(lambda *a: jax_ref.ssd_chunked(*a), *jspecs)
        p = count_step(lambda *a: ref.ssd_chunked(*a), *targs)
        return j["contracting"] + j["outer"] - p.flops

    def jfn(*a):
        y, vjp = jax.vjp(lambda *a_: jax_ref.ssd_chunked(*a_)[0], *a)
        return vjp(jnp.ones_like(y))

    def tfn(*a):
        a = [t.requires_grad_() for t in a]
        y, _ = ref.ssd_chunked(*a)
        torch.autograd.grad(y, a, torch.ones_like(y))
    j = _jax_count(jfn, *jspecs)
    p = count_step(tfn, *targs)
    return j["contracting"] + j["outer"] - p.flops


def _moe_dispatch_flops(cfg, kind, B, S) -> float:
    """JAX's dispatch and combine einsums: 2 B S E C D each a round and MoE
    layer, C from the length; to train five a round (the two, the
    dispatch's input gradient, the combine's two)."""
    if cfg.moe is None:
        return 0.0
    e = cfg.moe
    S = 1 if kind == "decode" else S
    cap = max(1, int(S * e.capacity_factor * e.top_k / e.n_experts))
    n_moe = sum(mlp == "moe" for _, mlp in cfg.block_pattern) * cfg.n_periods
    one = 2.0 * B * S * e.n_experts * cap * cfg.d_model
    return n_moe * e.top_k * one * (5 if kind == "train" else 2)


def _recomputing_oracle(q, k, v, *, impl=None, **kw):
    """`ops.attention` with its ``impl="ref"`` oracle recomputed in the
    backward, as JAX's ``jax.checkpoint``-ed oracle is."""
    assert ops.check_impl(impl) == "ref"
    fn = functools.partial(ref.mha_reference, **kw)
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        return torch.utils.checkpoint.checkpoint(fn, q, k, v, use_reentrant=False)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_count_step_matches_jax(arch, kind, monkeypatch):
    cfg, jcfg = get_config(arch + "-smoke"), jax_get_config(arch + "-smoke")
    sh = SMALL[kind]
    jb = jax_steps.input_specs(jcfg, JaxShapeCfg(**vars(sh)), impl="ref")
    j = _jax_count(jb.fn, *jb.arg_specs, table=(cfg.padded_vocab, cfg.d_model))
    b = steps.input_specs(cfg, sh, impl="ref")
    own = count_step(b.fn, *b.arg_specs)
    if kind == "train":
        monkeypatch.setattr(ops, "attention", _recomputing_oracle)
    cost = count_step(b.fn, *b.arg_specs)
    monkeypatch.undo()
    n_attn = sum(m == "attn" for m, _ in cfg.block_pattern) * cfg.n_periods
    if kind != "train":
        assert own.flops == cost.flops
    elif not cfg.encdec and not cfg.num_prefix and n_attn:
        a = cfg.attn
        assert cost.flops - own.flops == pytest.approx(
            n_attn * 4 * sh.global_batch * a.n_heads * sh.seq_len ** 2 * a.head_dim, rel=REL)
    port = _port_classes(cost)
    assert cost.flops == port["flops"] > 0
    n_mamba = sum(m == "mamba" for m, _ in cfg.block_pattern) * cfg.n_periods
    ssd = n_mamba * _ssd_difference(cfg, jcfg, kind, sh.global_batch, sh.seq_len) \
        if n_mamba else 0.0
    moe = _moe_dispatch_flops(cfg, kind, sh.global_batch, sh.seq_len)
    want = j["contracting"] + j["outer"] - ssd - moe
    assert cost.flops == pytest.approx(want, rel=REL), (cost.flops, want, ssd, moe)
    if not n_mamba and cfg.moe is None:
        assert cost.flops == pytest.approx(j["contracting"] + j["outer"], rel=REL)
        assert j["outer"] == 0
    # bytes: the products where no named class intervenes, and the
    # embedding's gather everywhere.  Named: the MoE's dispatch (JAX's
    # einsum products, the port's index_add / index_select and its
    # routing's gather and scatter); the loss's gather to train, which the
    # port's checkpointed chunk runs again in its backward, with int64
    # indices, and JAX's remat does not; the SSD's outer products
    if not n_mamba and cfg.moe is None:
        assert port["product_bytes"] == pytest.approx(j["bytes"]["dot_general"], rel=REL)
    assert cost.by_op["aten::index.Tensor"][1] == pytest.approx(j["bytes"]["embed_gather"],
                                                                rel=REL)
    if cfg.moe is None:
        assert "aten::index_add" not in port["ops"] and "aten::index_select" not in port["ops"]
    if kind == "train":
        assert cost.by_op["aten::gather"][1] > j["bytes"]["gather"]
    elif cfg.moe is None:
        assert "gather" not in j["bytes"] and "aten::gather" not in port["ops"]
    if kind == "decode" and "dynamic_update_slice" in j["bytes"]:
        # the slot write: int64 slot (8 bytes) for JAX's four int32 starts
        n_attn = sum(m == "attn" for m, _ in cfg.block_pattern) * cfg.n_periods
        assert cost.by_op["aten::index_copy_"][1] == pytest.approx(
            j["bytes"]["dynamic_update_slice"] + n_attn * 2 * (8 - 16), rel=REL)


@pytest.mark.parametrize("kind", KINDS)
def test_roofline_of_a_counted_step(kind):
    """`analyze_step` on jamba's reduced step: the terms from the counts on
    the H100's rates, the bottleneck the larger, 6 N D or 2 N D."""
    cfg = get_config("jamba-1.5-large-398b-smoke")
    sh = SMALL[kind]
    b = steps.input_specs(cfg, sh, impl="ref")
    cost = count_step(b.fn, *b.arg_specs)
    tokens = sh.global_batch * (1 if kind == "decode" else sh.seq_len)
    rep = analyze_step(arch=cfg.name, shape_name=kind, kind=kind, cfg=cfg, tokens=tokens,
                       step_flops=cost.flops, step_bytes=cost.major_bytes)
    assert rep.compute_s == pytest.approx(cost.flops / HW_H100.peak_flops)
    assert rep.memory_s == pytest.approx(cost.major_bytes / HW_H100.hbm_bw)
    assert rep.step_time_bound_s == max(rep.compute_s, rep.memory_s)
    assert rep.bottleneck == ("compute" if rep.compute_s > rep.memory_s else "memory")
    assert rep.model_flops == (6 if kind == "train" else 2) * cfg.active_param_count() * tokens
    assert rep.collective_s == 0 and rep.n_devices == 1 and "collectives" in rep.note
    assert rep.tokens_per_s == pytest.approx(tokens / rep.step_time_bound_s)
    assert '"bottleneck"' in rep.to_json()


@pytest.mark.parametrize("kind", KINDS)
def test_analyze_step_with_its_defaults_is_the_one_card_report(kind):
    """With no mesh and no collectives `analyze_step` gives the one-card
    report it gave before it took them, field for field: compute and
    memory on one card's rates, the collective term 0, the note that says
    why."""
    from repro_torch.analysis import RooflineReport
    cfg = get_config("qwen2.5-3b-smoke")
    sh = SMALL[kind]
    b = steps.input_specs(cfg, sh, impl="ref")
    cost = count_step(b.fn, *b.arg_specs)
    tokens = sh.global_batch * (1 if kind == "decode" else sh.seq_len)
    rep = analyze_step(arch=cfg.name, shape_name=kind, kind=kind, cfg=cfg, tokens=tokens,
                       step_flops=cost.flops, step_bytes=cost.major_bytes)
    compute_s, memory_s = cost.flops / HW_H100.peak_flops, cost.major_bytes / HW_H100.hbm_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": 0.0}
    bound = max(terms.values())
    useful = (6.0 if kind == "train" else 2.0) * cfg.active_param_count() * tokens
    want = RooflineReport(
        arch=cfg.name, shape=kind, mesh="1", n_devices=1, hlo_flops=cost.flops,
        hlo_bytes=cost.major_bytes, wire_bytes=0.0, compute_s=compute_s, memory_s=memory_s,
        collective_s=0.0, bottleneck=max(terms, key=terms.get), model_flops=useful,
        useful_flops_ratio=useful / cost.flops, collectives={"counts": {}, "wire_bytes": {}},
        step_time_bound_s=bound, tokens_per_s=tokens / bound,
        mfu=(useful / HW_H100.peak_flops) / bound,
        note="one card: no collectives (the JAX package parses them from its "
             "partitioned HLO, which the port has not); FLOPs and bytes from "
             "step_cost.count_step over the plain versions on the meta device")
    assert dataclasses.asdict(rep) == dataclasses.asdict(want)


def test_measure_host_bandwidth_is_a_copy_s_bytes_over_its_best_time(monkeypatch):
    """Two bytes moved (read and write) an element of the buffer, over the
    fastest of the timed copies: a clock that ticks 0.5 s then 0.25 s a
    copy gives 2 n 8 / 0.25."""
    from repro_torch.analysis import roofline
    ticks = iter([0.0, 0.5, 1.0, 1.25, 2.0, 2.5])
    monkeypatch.setattr(roofline.time, "perf_counter", lambda: next(ticks))
    n = 1 * (1 << 20) // 8
    assert roofline.measure_host_bandwidth(mbytes=1, repeats=3) == 2 * n * 8 / 0.25
    monkeypatch.undo()
    assert 1e8 < roofline.measure_host_bandwidth(mbytes=8, repeats=2) < 1e13


def test_full_size_jamba_is_described_without_allocating():
    """jamba-1.5-large-398b at full size: its 398 B parameters (796 GB in
    bf16) and a decode cell's count, all on the meta device."""
    cfg = get_config("jamba-1.5-large-398b")
    params = steps.abstract_params(cfg, serving=True)
    n = sum(p.numel() for p in params.parameters())
    assert 3.9e11 < n < 4.0e11
    assert 7.9e11 < sum(p.numel() * p.element_size() for p in params.parameters()) < 8.0e11
    sh = ShapeCfg("decode", 544, 8, "decode")
    b = steps.input_specs(cfg, sh, impl="ref", serving=True)
    cost = count_step(b.fn, *b.arg_specs)
    assert cost.flops > 2 * cfg.active_param_count() * 8 * 0.5
    assert cost.major_bytes > 0


def test_dtypes_of_a_meta_step_are_the_cells():
    """A counted step returns meta tensors of the JAX step's shapes."""
    cfg, jcfg = get_config("qwen2.5-3b-smoke"), jax_get_config("qwen2.5-3b-smoke")
    sh = SMALL["decode"]
    b = steps.input_specs(cfg, sh, impl="ref")
    logits, cache = b.fn(*b.arg_specs)
    jb = jax_steps.input_specs(jcfg, JaxShapeCfg(**vars(sh)), impl="ref")
    jl, _ = jax.eval_shape(jb.fn, *jb.arg_specs)
    assert logits.is_meta and tuple(logits.shape) == jl.shape
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
