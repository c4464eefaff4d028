"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain version; it is held
here against the JAX Pallas kernel run in interpret mode (as
``tests/test_kernels.py`` runs it), and the port's ``ref`` oracles are
held against the same.  Inputs come from seeded numpy and go to both
packages; both round them to bf16 the same way.

Tolerances: float32 2e-5, since the two sides sum in another order
(blocked online softmax in JAX, one softmax in the port); bf16 2e-2,
about two bf16 steps at magnitude 1, since both sides round the output to
bf16 from float32 values that differ in the last float32 bits.  The
attention sublayer takes 5e-5 in float32, as ``tests/test_kernels.py``
holds the JAX step, since it sums two more products of width D; the SSD
scan takes that file's 1e-4 (float32) and 5e-2 (bf16): its state sums
over the whole sequence and its bf16 inputs are rounded before the scan.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.fused_decode import _fused_pallas_step
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import blocks as jax_blocks
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_decode import (_composed_step, attn_decode_step,
                                              fused_decode_plain)
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(port, jax_out, dtype, f32_tol=2e-5):
    tol = 2e-2 if dtype == "bfloat16" else f32_tol
    np.testing.assert_allclose(port.float().numpy(), np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(4, 16), (3, 5, 64), (2, 7, 128), (2, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas(shape, dtype):
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng, shape, dtype)
    jw, tw = _pair(rng, shape[-1:], "float32")
    want = jax_rmsnorm(jx, jw, block_rows=2, interpret=True)
    got = rmsnorm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype)
    _close(ref.rmsnorm_reference(tx, tw), want, dtype)


FLASH_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, block)
    (1, 16, 16, 2, 2, 16, True, None, 8),      # GQA 1 (MHA)
    (2, 64, 64, 4, 2, 32, True, None, 16),     # GQA 2
    (2, 64, 64, 4, 2, 32, False, None, 16),    # not causal
    (1, 33, 33, 8, 2, 64, True, None, 16),     # GQA 4, ragged S
    (1, 37, 37, 4, 1, 16, False, None, 16),    # MQA, ragged, not causal
    (2, 32, 128, 4, 4, 32, True, None, 16),    # kv_offset = 96
    (1, 48, 48, 4, 2, 32, True, 7, 16),        # window
    (1, 96, 96, 8, 2, 120, True, 64, 32),      # danube's head dim, window 64
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(case, dtype):
    b, sq, sk, h, kv, d, causal, window, block = case
    rng = np.random.default_rng(sq * 31 + d)
    jq, tq = _pair(rng, (b, sq, h, d), dtype)
    jk, tk = _pair(rng, (b, sk, kv, d), dtype)
    jv, tv = _pair(rng, (b, sk, kv, d), dtype)
    kw = dict(causal=causal, window=window, kv_offset=sk - sq)
    want = jax_flash_attention(jq, jk, jv, block_q=block, block_k=block,
                               interpret=True, **kw)
    _close(flash_attention(tq, tk, tv, **kw), want, dtype)
    _close(ref.mha_reference(tq, tk, tv, **kw), want, dtype)


DECODE_CASES = [
    # (B, H, KV, hd, C, pos, window): the step writes slot pos % C and
    # attends with cache_len = min(pos + 1, C), as `Attention.decode` does
    (2, 8, 4, 32, 64, 16, None),      # short prefix of a long buffer
    (1, 8, 8, 16, 32, 31, None),      # full, MHA
    (2, 16, 2, 16, 24, 24, None),     # ring just wrapped, GQA 8
    (2, 8, 2, 32, 24, 5 * 24 + 3, None),   # wrapped many times
    (2, 8, 4, 32, 64, 63, 30),        # window inside a full ring
    (1, 8, 2, 120, 130, 99, 64),      # danube's head dim, window 64
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_pallas(case, dtype):
    b, h, kv, hd, c, pos, window = case
    clen = min(pos + 1, c)
    rng = np.random.default_rng(c * 13 + pos)
    jq, tq = _pair(rng, (b, h, hd), dtype)
    jk, tk = _pair(rng, (b, c, kv, hd), dtype)
    jv, tv = _pair(rng, (b, c, kv, hd), dtype)
    want = jax_decode_attention(jq, jk, jv, clen, window=window, block_k=32,
                                interpret=True)
    lens = torch.tensor(clen, dtype=torch.int32)
    _close(decode_attention(tq, tk, tv, lens, window=window), want, dtype)
    _close(ref.decode_attention_ref(tq, tk, tv, lens, window=window), want, dtype)


@pytest.mark.parametrize("window", [None, 12])
def test_decode_attention_per_sequence_lengths_match_chunked(window):
    rng = np.random.default_rng(11)
    jq, tq = _pair(rng, (3, 8, 32), "float32")
    jk, tk = _pair(rng, (3, 40, 4, 32), "float32")
    jv, tv = _pair(rng, (3, 40, 4, 32), "float32")
    lens = [1, 17, 40]
    want = jref.decode_attention_chunked(jq, jk, jv, jnp.asarray(lens), window=window,
                                         block_k=16)
    tlens = torch.tensor(lens, dtype=torch.int32)
    _close(decode_attention(tq, tk, tv, tlens, window=window), want, "float32")
    _close(ref.decode_attention_ref(tq, tk, tv, tlens, window=window), want, "float32")


def test_ops_dispatch_by_impl():
    rng = np.random.default_rng(6)
    _, q = _pair(rng, (1, 8, 4, 16), "float32")
    _, k = _pair(rng, (1, 8, 2, 16), "float32")
    assert torch.equal(ops.attention(q, k, k, impl="ref"), ref.mha_reference(q, k, k))
    assert torch.equal(ops.attention(q, k, k), flash_attention(q, k, k))
    w = torch.ones(16)
    assert torch.equal(ops.rmsnorm(q, w, impl="ref"), ref.rmsnorm_reference(q, w))
    with pytest.raises(ValueError):
        ops.rmsnorm(q, w, impl="pallas")


def _sublayer(name, dtype, B=3, C=16, seed=13):
    """Attention-sublayer weights (biases random where the config has them),
    a token x (B, D) and caches (B, C, KV, hd), seeded numpy, as a JAX and
    a torch keyword set."""
    cfg = jax_get_config(name)
    a = cfg.attn
    D, H, KV, hd = cfg.d_model, a.n_heads, a.n_kv_heads, a.head_dim
    rng = np.random.default_rng(seed)

    def mat(*shape, scale=1.0):
        return rng.normal(scale=scale, size=shape).astype(np.float32)

    w = {"norm": 1.0 + mat(D, scale=0.1), "wq": mat(D, H * hd, scale=D ** -0.5),
         "wk": mat(D, KV * hd, scale=D ** -0.5), "wv": mat(D, KV * hd, scale=D ** -0.5),
         "wo": mat(H * hd, D, scale=(H * hd) ** -0.5)}
    if a.qkv_bias:
        w.update(bq=mat(H * hd, scale=0.1), bk=mat(KV * hd, scale=0.1),
                 bv=mat(KV * hd, scale=0.1))
    data = {"x": mat(B, D), "k": mat(B, C, KV, hd, scale=0.1), "v": mat(B, C, KV, hd, scale=0.1)}
    jdt, tdt = DTYPES[dtype]
    jw = {k: jnp.asarray(v, jnp.float32 if k == "norm" else jdt) for k, v in w.items()}
    tw = {k: torch.from_numpy(v).to(torch.float32 if k == "norm" else tdt)
          for k, v in w.items()}
    jd = {k: jnp.asarray(v, jdt) for k, v in data.items()}
    td = {k: torch.from_numpy(v).to(tdt) for k, v in data.items()}
    static = dict(n_heads=H, head_dim=hd, eps=cfg.norm_eps)
    return cfg, jw, tw, jd, td, static, a.rope_theta


def _bias_kw(w):
    return {k: w.get(k) for k in ("bq", "bk", "bv")}


@pytest.mark.parametrize("pos", [0, 3, 15, 16, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_decode_plain_matches_pallas(pos, dtype):
    """The plain version == the JAX `_fused_kernel` in interpret mode, in
    the growing (pos < C), boundary (pos == C) and wrapped states: out,
    and the new rows against the slot the JAX step wrote."""
    _, jw, tw, jd, td, static, theta = _sublayer("tiny", dtype)
    kw = dict(static, theta=theta, scale=static["head_dim"] ** -0.5)
    jw_kw = {k: jw[k] for k in ("norm", "wq", "wk", "wv", "wo")}
    out, kc, vc = _fused_pallas_step(jd["x"], jd["k"], jd["v"], jnp.int32(pos), **jw_kw,
                                     **_bias_kw(jw), interpret=True, **kw)
    got, k_new, v_new = fused_decode_plain(
        td["x"], td["k"], td["v"], torch.tensor(pos, dtype=torch.int32),
        **{k: tw[k] for k in ("norm", "wq", "wk", "wv", "wo")}, **_bias_kw(tw), **kw)
    assert got.dtype == td["x"].dtype and k_new.dtype == td["k"].dtype
    slot = pos % td["k"].shape[1]
    _close(got, out[:, 0], dtype, 5e-5)
    _close(k_new, kc[:, slot], dtype, 5e-5)
    _close(v_new, vc[:, slot], dtype, 5e-5)


def _attn_params(w):
    return {k: w[k] for k in ("norm", "wq", "wk", "wv", "wo", "bq", "bk", "bv") if k in w}


@pytest.mark.parametrize("name", ["tiny", "qwen2.5-3b-smoke"])
@pytest.mark.parametrize("pos", [2, 16, 37])
def test_attn_decode_step_matches_jax_ref_body(name, pos):
    """The port's step on the CPU (the plain version plus the slot write)
    == the JAX op-by-op `attn_decode(impl="ref")`: out and both caches."""
    cfg, jw, tw, jd, td, static, theta = _sublayer(name, "float32", seed=pos)
    jx = jd["x"][:, None]
    want, jc = jax_blocks.attn_decode(_attn_params(jw), cfg, jx, {"k": jd["k"], "v": jd["v"]},
                                      jnp.int32(pos), impl="ref")
    k, v = td["k"].clone(), td["v"].clone()
    got = attn_decode_step(td["x"][:, None], k, v, torch.tensor(pos, dtype=torch.int32),
                           **_attn_params(tw), n_heads=static["n_heads"],
                           head_dim=static["head_dim"], eps=static["eps"], rope_theta=theta)
    _close(got, want, "float32", 5e-5)
    _close(k, jc["k"], "float32", 5e-5)
    _close(v, jc["v"], "float32", 5e-5)


@pytest.mark.parametrize("pos", [0, 16, 40])
def test_composed_step_matches_plain(pos):
    _, _, tw, _, td, static, theta = _sublayer("qwen2.5-3b-smoke", "float32")
    kw = dict(**{k: tw[k] for k in ("norm", "wq", "wk", "wv", "wo")}, **_bias_kw(tw),
              **static, theta=theta, scale=static["head_dim"] ** -0.5)
    p = torch.tensor(pos, dtype=torch.int32)
    want, k_new, v_new = fused_decode_plain(td["x"], td["k"], td["v"], p, **kw)
    k, v = td["k"].clone(), td["v"].clone()
    got = _composed_step(td["x"][:, None], k, v, p, **kw)
    slot = pos % k.shape[1]
    torch.testing.assert_close(got[:, 0], want, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(k[:, slot], k_new, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(v[:, slot], v_new, atol=5e-5, rtol=5e-5)


SSD_SHAPES = [
    # (B, L, H, P, N, chunk), as tests/test_kernels.py
    (1, 16, 1, 4, 8, 4),
    (2, 64, 3, 8, 16, 16),
    (1, 50, 2, 16, 32, 16),   # ragged
    (2, 128, 4, 64, 128, 32),  # production-like dims
]


def _ssd_inputs(shape, dtype):
    b, l, h, p, n, _ = shape
    rng = np.random.default_rng(sum(shape) * 7 + len(dtype))
    jdt, tdt = DTYPES[dtype]
    arrays = {"x": rng.normal(size=(b, l, h, p)), "dt": rng.uniform(0.05, 0.8, size=(b, l, h)),
              "b": rng.normal(size=(b, l, n)), "c": rng.normal(size=(b, l, n))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    a = -rng.uniform(0.5, 1.5, size=(h,)).astype(np.float32)
    jax_in = [jnp.asarray(arrays[k], jdt) for k in ("x", "dt")] + [jnp.asarray(a)] + \
        [jnp.asarray(arrays[k], jdt) for k in ("b", "c")]
    torch_in = [torch.from_numpy(arrays[k]).to(tdt) for k in ("x", "dt")] + \
        [torch.from_numpy(a)] + [torch.from_numpy(arrays[k]).to(tdt) for k in ("b", "c")]
    return jax_in, torch_in


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_pallas_and_oracle(shape, dtype):
    chunk = shape[-1]
    jin, tin = _ssd_inputs(shape, dtype)
    want_y, want_s = jax_ssd_scan(*jin, chunk=chunk, interpret=True)
    ref_y, ref_s = jref.ssd_reference(*jin)
    got_y, got_s = ssd_scan(*tin, chunk=chunk)          # the plain version on the CPU
    assert got_y.dtype == tin[0].dtype and got_s.dtype == torch.float32
    tol = 5e-2 if dtype == "bfloat16" else 1e-4
    for want, oracle, got in ((want_y, ref_y, got_y), (want_s, ref_s, got_s)):
        for w in (want, oracle):
            np.testing.assert_allclose(got.float().numpy(), np.asarray(w, np.float32),
                                       atol=tol, rtol=tol)
    torch.testing.assert_close(ssd_scan_plain(*tin, chunk=chunk)[1], got_s)


def test_ssd_oracles_match_jax():
    jin, tin = _ssd_inputs((2, 37, 3, 8, 16, 8), "float32")
    for jfn, tfn in ((jref.ssd_reference, ref.ssd_reference),
                     (lambda *a: jref.ssd_chunked(*a, chunk=8),
                      lambda *a: ref.ssd_chunked(*a, chunk=8))):
        jy, js = jfn(*jin)
        ty, ts = tfn(*tin)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=1e-5)
    d_skip = np.linspace(0.5, 1.5, 3).astype(np.float32)
    jy, _ = jref.ssd_chunked(*jin, chunk=8, d_skip=jnp.asarray(d_skip))
    ty, _ = ref.ssd_chunked(*tin, chunk=8, d_skip=torch.from_numpy(d_skip))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)


def test_ssd_decode_step_matches_jax():
    jin, tin = _ssd_inputs((2, 5, 3, 8, 16, 8), "float32")
    rng = np.random.default_rng(9)
    s0 = rng.normal(size=(2, 3, 8, 16)).astype(np.float32)
    d_skip = np.linspace(0.5, 1.5, 3).astype(np.float32)
    jx, jdt, ja, jb, jc = jin
    tx, tdt, ta, tb, tc = tin
    js, ts = jnp.asarray(s0), torch.from_numpy(s0)
    for t in range(5):
        jy, js = jref.ssd_decode_step(js, jx[:, t], jdt[:, t], ja, jb[:, t], jc[:, t],
                                      d_skip=jnp.asarray(d_skip))
        ty, ts = ref.ssd_decode_step(ts, tx[:, t], tdt[:, t], ta, tb[:, t], tc[:, t],
                                     d_skip=torch.from_numpy(d_skip))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=1e-5)


def test_ops_ssd_dispatch_by_impl():
    _, tin = _ssd_inputs((1, 20, 2, 8, 16, 8), "float32")
    want = ref.ssd_chunked(*tin, chunk=8)
    for impl in (None, "ref"):
        got = ops.ssd(*tin, chunk=8, impl=impl)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        ops.ssd(*tin, impl="pallas")
