"""Mamba2 training in the port: the plain backward functions of the SSD
scan and of the gated norm, their wrappers and autograd Functions, on the
CPU.

``ref.ssd_chunked_backward`` and ``ref.rmsnorm_gated_backward`` are the
card's backward kernels written step by step in plain PyTorch.  They are
held against autograd of the port's forward plain versions and against
``jax.vjp`` of the JAX package's oracles (``repro.kernels.ref``'s
``ssd_chunked`` and ``ssd_reference``; the JAX block's gate body before
``rmsnorm_reference``).  Inputs come from seeded numpy and go to both
packages.  The autograd Functions (`_SsdScan`, `_RmsNormGated`) launch
kernels on the card; here their forward is swapped for its plain version
so that their backward wiring runs on the CPU, alone and in a
mamba2-370m-smoke loss against ``jax.value_and_grad``.

Tolerances, as a share of the gradient's largest entry (and 1e-6 beside,
for gradients that vanish): float32 1e-4 (sums
of float32 products in another order, over up to 129 tokens and the
heads); bf16 2e-2 (both sides round each gradient to bf16 once, from
float32 values that differ in their last bits; the gate's d_skip gradient
is a float32 sum here and a bf16 one in autograd).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import lm as jax_lm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.data import DataState, make_pipeline
from repro_torch.kernels import build, ops, ref
from repro_torch.launch.steps import make_train_step
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import lm

NORM_CARD = rn.Card(sms=132, threads=2048, registers=65536)   # an H100
FOLD_FLOATS = 8 * 32 * 2 * 8     # the row kernels' fold buffer in rmsnorm.cu, in floats
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _close_scaled(got, want, tol, what=""):
    want, got = (t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)
                 for t in (want, got))
    assert got.shape == want.shape, what
    # 1e-6 beside: a gradient that is 0 in exact arithmetic (da at L 1, where
    # no token decays another) comes out as float32 noise
    np.testing.assert_allclose(got, want, atol=tol * float(np.abs(want).max()) + 1e-6, rtol=0,
                               err_msg=what)


def _ssd_case(b, L, h, p, n, dtype, with_state, seed):
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    arrays = dict(x=rng.normal(size=(b, L, h, p)), dt=rng.uniform(0.05, 0.8, size=(b, L, h)),
                  a=-rng.uniform(0.5, 1.5, size=(h,)), b=rng.normal(size=(b, L, n)),
                  c=rng.normal(size=(b, L, n)), dy=rng.normal(size=(b, L, h, p)),
                  ds=rng.normal(size=(b, h, p, n)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    typed = ("x", "b", "c", "dy")     # in the compute dtype; dt, a and the state float32
    jin = {k: jnp.asarray(v, jdt if k in typed else jnp.float32) for k, v in arrays.items()}
    tin = {k: torch.from_numpy(v).to(tdt if k in typed else torch.float32)
           for k, v in arrays.items()}
    if not with_state:
        jin["ds"], tin["ds"] = jnp.zeros_like(jin["ds"]), None
    return jin, tin


# (L, chunk): one token, a second chunk of one token (65 at 64), a ragged
# length over three chunks of 64 and over nine of 16
@pytest.mark.parametrize("L,chunk", [(1, 64), (1, 16), (65, 64), (65, 16), (129, 64),
                                     (129, 16)])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_backward_matches_autograd_and_jax_vjp(L, chunk, with_state, dtype):
    jin, tin = _ssd_case(2, L, 3, 8, 16, dtype, with_state, seed=L * 7 + chunk)
    tol = DTYPES[dtype][2]
    args = [tin[k] for k in ("x", "dt", "a", "b", "c")]
    got = ref.ssd_chunked_backward(*args, tin["dy"], tin["ds"], chunk=chunk)
    assert [g.dtype for g in got] == [args[0].dtype, torch.float32, torch.float32,
                                      args[0].dtype, args[0].dtype]
    leaves = [t.clone().requires_grad_(True) for t in args]
    y, s = ref.ssd_chunked(*leaves, chunk=32)
    torch.autograd.backward([y, s] if with_state else [y],
                            [tin["dy"], tin["ds"]] if with_state else [tin["dy"]])
    jargs = [jin[k] for k in ("x", "dt", "a", "b", "c")]
    for jfn in (lambda *a: jref.ssd_chunked(*a, chunk=32), jref.ssd_reference):
        _, vjp = jax.vjp(jfn, *jargs)
        want = vjp((jin["dy"], jin["ds"]))
        for name, g, w, leaf in zip(("dx", "ddt", "da", "db", "dc"), got, want, leaves):
            _close_scaled(g, w, tol, f"{name} against jax.vjp")
            _close_scaled(g, leaf.grad, tol, f"{name} against autograd")


def test_ssd_chunked_backward_sums_b_and_c_over_every_head():
    """db and dc are one group's, shared by the heads: each is the sum of
    the per-head gradients (the scan run one head at a time)."""
    _, tin = _ssd_case(1, 70, 4, 8, 16, "float32", True, seed=3)
    x, dt, a, b, c, dy, ds = (tin[k] for k in ("x", "dt", "a", "b", "c", "dy", "ds"))
    _, _, _, db, dc = ref.ssd_chunked_backward(x, dt, a, b, c, dy, ds)
    parts = [ref.ssd_chunked_backward(x[:, :, i:i + 1], dt[:, :, i:i + 1], a[i:i + 1], b, c,
                                      dy[:, :, i:i + 1], ds[:, i:i + 1]) for i in range(4)]
    torch.testing.assert_close(db, sum(p[3] for p in parts), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dc, sum(p[4] for p in parts), atol=1e-5, rtol=1e-5)


def _gate_case(lead, heads, width, dtype, seed):
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    di = heads * width
    arrays = dict(y=rng.normal(size=(*lead, heads, width)),
                  xh=rng.normal(size=(*lead, heads, width)),
                  d=1.0 + 0.1 * rng.normal(size=(heads,)), xz=rng.normal(size=(*lead, 2 * di)),
                  w=1.0 + 0.1 * rng.normal(size=(di,)), g=rng.normal(size=(*lead, di)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    typed = ("y", "xh", "xz", "g")
    jin = {k: jnp.asarray(v, jdt if k in typed else jnp.float32) for k, v in arrays.items()}
    tin = {k: torch.from_numpy(v).to(tdt if k in typed else torch.float32)
           for k, v in arrays.items()}
    jin["z"], tin["z"] = jin["xz"][..., di:], torch.chunk(tin["xz"], 2, dim=-1)[1]
    assert tin["z"].stride(-2) == 2 * di
    return jin, tin


def _jax_gate(y, xh, d, z, w):
    """The JAX block's body (`mamba_forward`) from the skip to the gate norm."""
    g = (y + xh * d[:, None].astype(xh.dtype)).reshape(z.shape) * jax.nn.silu(z)
    return jref.rmsnorm_reference(g, w, 1e-5)


GATED_SHAPES = [((2, 5), 4, 8), ((3,), 4, 8), ((2, 3), 2, 16), ((1,), 3, 4)]


@pytest.mark.parametrize("lead,heads,width", GATED_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_gated_backward_matches_autograd_and_jax_vjp(lead, heads, width, dtype):
    jin, tin = _gate_case(lead, heads, width, dtype, seed=heads * 10 + width)
    tol = DTYPES[dtype][2]
    args = [tin[k] for k in ("y", "xh", "d", "z", "w")]
    got = ref.rmsnorm_gated_backward(*args, tin["g"])
    assert [g.dtype for g in got] == [args[0].dtype, args[0].dtype, torch.float32,
                                      args[0].dtype, torch.float32]
    assert got[3].shape == tin["z"].shape
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    rn.rmsnorm_gated_plain(*leaves).backward(tin["g"])
    _, vjp = jax.vjp(_jax_gate, *(jin[k] for k in ("y", "xh", "d", "z", "w")))
    want = vjp(jin["g"])
    for name, g, w, leaf in zip(("dy", "dxh", "dd_skip", "dz", "dw"), got, want, leaves):
        _close_scaled(g, w, tol, f"{name} against jax.vjp")
        _close_scaled(g, leaf.grad, tol, f"{name} against autograd")


def test_backward_wrappers_take_the_plain_versions_on_the_cpu():
    _, tin = _ssd_case(2, 70, 3, 8, 16, "float32", True, seed=5)
    args = [tin[k] for k in ("x", "dt", "a", "b", "c", "dy", "ds")]
    before = ss.ssd_scan_backward.launches
    got = ss.ssd_scan_backward(*args)
    want = ref.ssd_chunked_backward(*args, chunk=ss.CHUNK)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    _, gin = _gate_case((2, 5), 4, 8, "bfloat16", seed=6)
    gargs = [gin[k] for k in ("y", "xh", "d", "z", "w", "g")]
    got = rn.rmsnorm_gated_backward(*gargs)
    want = ref.rmsnorm_gated_backward(*gargs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ss.ssd_scan_backward.launches == before


def test_backward_wrappers_raise_on_inputs_they_do_not_take(monkeypatch):
    """Past the device check (meta tensors stand for the card's), the new
    backward wrappers refuse, with their messages and before any launch, a
    dtype, shape or layout the kernels do not take."""
    monkeypatch.setattr(build, "check_cuda", lambda *a: None)
    monkeypatch.setattr(build, "call", lambda *a: pytest.fail("launched"))

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    x, dt, a, bc, dy = z(1, 8, 2, 16), z(1, 8, 2), z(2), z(1, 8, 32), z(1, 8, 2, 16)
    with pytest.raises(ValueError, match="dy as x"):
        ss.ssd_scan_backward(x, dt, a, bc, bc, z(1, 8, 2, 8))
    with pytest.raises(ValueError, match="dy as x"):
        ss.ssd_scan_backward(x, dt, a, bc, bc, dy.bfloat16())
    with pytest.raises(ValueError, match="d_state"):
        ss.ssd_scan_backward(x, dt, a, bc, bc, dy, z(1, 2, 16, 16))
    with pytest.raises(ValueError, match="P <= 64"):
        big = z(1, 8, 2, 128)
        ss.ssd_scan_backward(big, dt, a, bc, bc, big)
    with pytest.raises(ValueError, match="of one dtype"):
        ss.ssd_scan_backward(x, dt, a, bc.bfloat16(), bc, dy)
    with pytest.raises(ValueError, match="must be contiguous"):
        ss.ssd_scan_backward(z(1, 8, 16, 2).transpose(2, 3), dt, a, bc, bc, dy)

    y, d, w = z(3, 2, 8), z(2), z(16)
    zz = torch.chunk(z(3, 32), 2, dim=-1)[1]
    with pytest.raises(ValueError, match="g as z"):
        rn.rmsnorm_gated_backward(y, y, d, zz, w, z(3, 8))
    with pytest.raises(ValueError, match="g as z"):
        rn.rmsnorm_gated_backward(y, y, d, zz, w, z(3, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="width <= 25000"):
        wide = z(2, 2, 13_000)
        rn.rmsnorm_gated_backward(wide, wide, d, z(2, 26_000), z(26_000), z(2, 26_000))
    with pytest.raises(ValueError, match="d_skip .H,. and w .H.P,. float32"):
        rn.rmsnorm_gated_backward(y, y, d.bfloat16(), zz, w, z(3, 16))
    with pytest.raises(ValueError, match="evenly spaced"):
        rn.rmsnorm_gated_backward(y, y, d, z(3, 16).t().contiguous().t(), w, z(3, 16))


def _route_through_the_functions(monkeypatch):
    """The autograd Functions with their forward kernels swapped for the
    plain versions, and ``ops`` routed through them: on the CPU their
    backward is the plain backward, as the kernels' is on the card."""
    monkeypatch.setattr(ss, "_forward", lambda x, dt, a, b, c: ref.ssd_chunked(x, dt, a, b, c))
    monkeypatch.setattr(rn, "_gated_forward",
                        lambda y, xh, d, z, w, eps: rn.rmsnorm_gated_plain(y, xh, d, z, w,
                                                                           eps=eps))
    monkeypatch.setattr(ops, "_ssd_scan",
                        lambda x, dt, a, b, c, chunk: ss._SsdScan.apply(x, dt.float(), a, b, c))
    monkeypatch.setattr(ops, "rmsnorm_gated",
                        lambda y, xh, d, z, w, eps: rn._RmsNormGated.apply(y, xh, d, z, w, eps))


@pytest.mark.parametrize("use_state", [False, True])
def test_ssd_function_gradients_with_and_without_the_state(monkeypatch, use_state):
    """`_SsdScan`: the gradients of y alone (a training loss: the final
    state's gradient comes in as None), and of y and the final state, equal
    autograd of the plain version."""
    _route_through_the_functions(monkeypatch)
    _, tin = _ssd_case(2, 70, 3, 8, 16, "float32", True, seed=8)
    args = [tin[k] for k in ("x", "dt", "a", "b", "c")]
    leaves = [t.clone().requires_grad_(True) for t in args]
    before = ss.ssd_scan_backward.launches
    y, s = ss._SsdScan.apply(*leaves)
    loss = (y.float() * tin["dy"]).sum() + ((s * tin["ds"]).sum() if use_state else 0.0)
    loss.backward()
    want_leaves = [t.clone().requires_grad_(True) for t in args]
    wy, ws = ref.ssd_chunked(*want_leaves)
    ((wy.float() * tin["dy"]).sum() + ((ws * tin["ds"]).sum() if use_state else 0.0)).backward()
    for got, want in zip(leaves, want_leaves):
        _close_scaled(got.grad, want.grad, 1e-4)
    assert ss.ssd_scan_backward.launches == before     # the CPU path counts no launch


# rows and widths: mamba2-370m's training rows at its width (2048), the
# reduced configs' widths, a width of a ragged number of pieces (1000), one
# beyond a row of 8 warps (5120, mamba2-2.7b) and decode-sized rows
@pytest.mark.parametrize("rows", [1, 8, 131, 8192])
@pytest.mark.parametrize("d,elem", [(2048, 2), (1000, 2), (64, 2), (1024, 4), (2048, 4),
                                    (5120, 2)])
def test_gated_bwd_plan_holds_a_row_in_one_piece_a_lane(rows, d, elem):
    """The gated backward's launch: one 16-byte piece of each input a lane
    (the kernels' one instance); in the row kernel, the row groups' two
    float32 shares a column within the fold buffer; past 8 warps (5120, and
    2048 float32), the cluster kernel (a CTA of 16 warps, or a cluster of
    CTAs of 8), which writes its shares straight to a partial row a
    cluster; no block or cluster without a row; what does not fit
    goes to the wide kernel, whose block keeps two floats a column."""
    plan = rn.norm_bwd_plan(rows, d, elem, aligned=True, card=NORM_CARD, gated=True)
    pieces = d * elem // 16
    if plan.warps == 0:
        assert pieces > 32 * rn.THREADS // 32 * rn.MAX_CTAS
        assert 2 * d * 4 <= 232_448
        return
    assert plan.units == rn.GATED_BWD_UNITS == 1
    assert 32 * plan.warps * plan.ctas >= pieces
    if not plan.cluster:
        assert plan.warps * plan.groups <= rn.THREADS // 32
        assert 2 * plan.groups * d <= FOLD_FLOATS
    else:
        assert plan.groups == 1 and pieces > rn.THREADS and plan.warps in (8, 16)
    # no block (no cluster) without a row
    assert 1 <= plan.blocks // plan.ctas <= -(-rows // plan.groups)


def test_gated_bwd_plan_at_mamba_training_rows():
    assert rn.norm_bwd_plan(8192, 2048, 2, aligned=True, card=NORM_CARD, gated=True) == \
        rn.NormPlan(warps=8, units=1, groups=1, blocks=264)
    assert rn.norm_bwd_plan(8192, 2048, 2, aligned=False, card=NORM_CARD, gated=True) == \
        rn.NormPlan(0, 0, 0, 264)


@pytest.mark.parametrize("h,p", [(32, 64), (4, 250), (3, 20), (64, 8), (5, 3), (1, 25_000)])
def test_gated_bwd_tail_covers_every_head_once(h, p):
    """The tail's blocks take tail_heads(P) heads each, at least 32 columns
    where a head is narrower, and every head falls in exactly one block;
    their columns fit the block's shared memory."""
    hpb = rn.tail_heads(p)
    blocks = -(-h // hpb)
    owners = [hd // hpb for hd in range(h)]
    assert sorted(set(owners)) == list(range(blocks))
    assert hpb * p >= min(32, p) and (hpb == 1 or hpb * p <= 32)
    assert 4 * hpb * p <= 232_448


@pytest.mark.parametrize("batch,length,heads", [(2, 4096, 32), (1, 1, 3), (2, 65, 16),
                                                (8, 4096, 32), (1, 16384, 32)])
def test_ssd_bwd_scratch_follows_from_the_shapes(batch, length, heads):
    """The states' scratch: a float32 slot of 64 rows of 128 floats (the
    kernel's `SLAB`) a (sequence, head, chunk of 64 tokens), twice; da's
    shares a (sequence, chunk, head)."""
    shapes = ss.bwd_scratch_shapes(batch, length, heads)
    chunks = -(-length // 64)
    assert ss.CHUNK == 64 and ss.SLOT == 64 * 128
    assert shapes == {"starts": (batch, heads, chunks, 8192),
                      "dstates": (batch, heads, chunks, 8192),
                      "da_part": (batch, chunks, heads)}


def _mamba_smoke(compute_dtype, **kw):
    """mamba2-370m-smoke in both packages from one JAX ``init_params`` (its
    Mamba scalars and norms made random with numpy), and a batch."""
    jcfg = dataclasses.replace(jax_get_config("mamba2-370m-smoke"), compute_dtype=compute_dtype,
                               **kw)
    cfg = dataclasses.replace(get_config("mamba2-370m-smoke"), compute_dtype=compute_dtype,
                              **kw)
    tree = jax.tree.map(np.array, jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for pos in tree["layers"].values():
        for part in pos.values():
            for key, center in (("dt_bias", 0.0), ("a_log", 0.0), ("d_skip", 1.0),
                                ("gate_norm", 1.0), ("norm", 1.0)):
                if key in part:
                    part[key] = (center + rng.normal(scale=0.1, size=part[key].shape)
                                 ).astype(np.float32)
    batch = {k: rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
             for k in ("tokens", "labels")}
    return jcfg, cfg, tree, batch


def _port_loss_and_grads(cfg, tree, batch):
    model = bridge.from_jax(cfg, tree, device="cpu", param_dtype=torch.float32)
    loss, _ = lm.loss_fn(cfg, model, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}


def test_mamba_loss_through_the_functions_matches_jax(monkeypatch):
    """The slice as a whole: mamba2-370m-smoke's loss and every gradient
    leaf through `_SsdScan` and `_RmsNormGated` (their plain backward),
    float32, against ``jax.value_and_grad`` of the JAX package's
    ``loss_fn`` with ``impl="ref"``: loss 1e-5 relative, each leaf within
    1e-4 of its largest JAX entry, as ``tests/test_torch_train.py``."""
    jcfg, cfg, tree, batch = _mamba_smoke("float32")
    (want_loss, _), jgrads = jax.value_and_grad(
        lambda p: jax_lm.loss_fn(jcfg, p, batch, impl="ref"), has_aux=True)(tree)
    want = bridge._flat_jax(cfg, jax.tree.map(np.asarray, jgrads))
    _route_through_the_functions(monkeypatch)
    calls = {"ssd": 0, "gate": 0}
    for name, cls in (("ssd", ss._SsdScan), ("gate", rn._RmsNormGated)):
        def counted(ctx, *g, _fn=cls.backward, _name=name):
            calls[_name] += 1
            return _fn(ctx, *g)
        monkeypatch.setattr(cls, "backward", staticmethod(counted))
    loss, got = _port_loss_and_grads(cfg, tree, batch)
    layers = sum(1 for k in got if k.endswith("a_log"))
    assert layers > 1 and calls == {"ssd": layers, "gate": layers}
    assert got.keys() == want.keys()
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    for k, g in got.items():
        _close_scaled(g, want[k], 1e-4, k)


def test_mamba_loss_through_the_functions_in_bf16_matches_autograd(monkeypatch):
    """bf16: the Functions' route against autograd of the port's plain
    versions on the same float32 masters and batch (the same forward, bit
    for bit).  The loss is equal; each leaf within 1e-2 of its norm,
    relative L2 (the gate's d_skip gradient is a float32 sum here and a
    bf16 one in autograd, 2^-9 apart; every other leaf agrees to ~1e-5).
    Against the JAX package, bf16 leaves move by up to 0.2 with the batch
    (the two frameworks round the projections from different float32 bits:
    ``tests/test_torch_train.py``), which would hide a fault of this size."""
    _, cfg, tree, batch = _mamba_smoke("bfloat16")
    want_loss, want = _port_loss_and_grads(cfg, tree, batch)
    _route_through_the_functions(monkeypatch)
    loss, got = _port_loss_and_grads(cfg, tree, batch)
    assert loss == want_loss
    for k, g in got.items():
        assert float((g - want[k]).norm() / (want[k].norm() + 1e-12)) < 1e-2, k


def test_train_steps_of_a_stack_without_mlp_match_jax():
    """mamba2-370m has no MLP (d_ff 0), yet each layer keeps the MLP's norm,
    which no loss reaches: its gradient is zero, as ``jax.grad`` gives it,
    and AdamW still decays it.  Two steps with accumulation 2 of the smoke
    config cut to d_ff 0 against JAX's unjitted ``make_train_step(cfg,
    impl="ref")``: loss 1e-5 relative; parameters within 1e-5 of their
    largest entry and 1e-2 of the learning rate beside (AdamW moves an
    element whose gradient is near its eps by a share of the learning rate
    that float noise in that gradient changes); the unreached norms, whose
    gradient is exactly zero, as JAX's to float32 rounding."""
    jcfg, cfg, tree, _ = _mamba_smoke("float32", d_ff=0, grad_accum=2)
    kw = dict(lr=1e-3, warmup=1, total_steps=10)
    _, jopt, jstep = jax_make_train_step(jcfg, impl="ref", **kw)
    opt, step_fn = make_train_step(cfg, **kw)
    pipe = make_pipeline("bigram", cfg, ShapeCfg("c", 24, 4, "train"), seed=1, accum=2)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    model = bridge.from_jax(cfg, tree, device="cpu", param_dtype=torch.float32)
    state = opt.init(dict(model.named_parameters()))
    for step in range(2):
        batch = pipe.host_batch(DataState(step, 1))
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(step, jnp.int32), batch)
        m = step_fn(model, state, step, {k: torch.from_numpy(v).long() for k, v in batch.items()})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    unreached = [k for k, p in model.named_parameters() if k.endswith("mlp.norm")]
    assert unreached and all(not model.get_parameter(k).grad.any() for k in unreached)
    want = bridge._flat_jax(cfg, jax.tree.map(np.asarray, jparams))
    for k, p in model.named_parameters():
        w = np.asarray(want[k], np.float32)
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, err_msg=k,
                                   atol=1e-5 * float(np.abs(w).max()) + 1e-2 * kw["lr"])
    for k in unreached:
        np.testing.assert_allclose(model.get_parameter(k).detach().numpy(),
                                   np.asarray(want[k], np.float32), rtol=1e-6, err_msg=k)
