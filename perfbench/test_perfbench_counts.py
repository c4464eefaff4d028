"""The benchmark's FLOP and byte counts: one decode attention sublayer and
one MLP against numbers worked out by hand, and a whole decode step of
each configuration's reduced form against the port's own count
(``repro_torch.analysis.step_cost.count_step`` of the oracle route)."""
import pytest

from perfbench.harness import port, work
from perfbench.kinds import attn, dense_mlp, embed_head
from perfbench.test_perfbench_reference import CONFIGS, reduced


def test_decode_attention_by_hand():
    m = reduced("deepseek-coder-33b")           # D 64, H 4, KV 2, hd 16
    # rows at context 10 and 20: projections 2 * (64 * 8 * 16 + 64 * 64) a
    # row, attention 4 * H * hd a position of context
    flops, nbytes = attn.decode_work(m, [10, 20])
    assert flops == 2 * 24576 + 4 * 4 * 16 * 30
    # bf16 weights once (24576 B) and the float32 norm (256 B); K and V
    # of 2 heads x 16 over 30 positions in bf16; each row's new slot and
    # its x in and out
    assert nbytes == 24576 + 256 + 2 * 2 * 32 * 30 + 2 * 2 * (2 * 32 + 2 * 64)


def test_prefill_attention_by_hand():
    m = reduced("nemotron-4-15b")
    flops, nbytes = attn.prefill_work(m, [3, 5])   # 8 tokens; 6 + 15 causal pairs
    assert flops == 8 * 24576 + 4 * 4 * 16 * 21
    assert nbytes == 24576 + 256 + 8 * 2 * (2 * 64 + 2 * 32)


@pytest.mark.parametrize("name,mats", [("deepseek-coder-33b", 3), ("nemotron-4-15b", 2)])
def test_mlp_by_hand(name, mats):
    m = reduced(name)                            # D 64, F 128
    flops, nbytes = dense_mlp.decode_work(m, [7, 9])
    assert flops == 2 * 2 * mats * 64 * 128
    assert nbytes == 2 * mats * 64 * 128 + 4 * 64 + 2 * 2 * 2 * 64


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_step_against_the_port_count(name):
    from repro_torch.analysis.step_cost import count_step
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import steps
    m = reduced(name, "bfloat16")
    B, C = 3, 40
    cfg = port.model_config(m)
    b = steps.input_specs(cfg, ShapeCfg("d", C, B, "decode"), impl="ref", serving=True)
    got = count_step(b.fn, *b.arg_specs)
    rows = [C] * B           # the oracle attends the whole cache: count every row at C
    layers = m["n_layers"]
    a_f, _ = attn.decode_work(m, rows)
    ctx_f = 4.0 * 4 * 16 * B * C
    mlp_f, _ = dense_mlp.decode_work(m, rows)
    head_f, _ = embed_head.work(m, B)
    assert got.by_op["aten::bmm"][0] == layers * ctx_f
    assert got.by_op["aten::mm"][0] == layers * (a_f - ctx_f + mlp_f) + head_f
    assert got.flops == layers * (a_f + mlp_f) + head_f
    # bytes: the port counts every operand and result of each product, so
    # its products' bytes are the weights (ours, less the float32 norms)
    # and each product's rows in and out; its attention reads the oracle's
    # float32 copies of K and V, repeated to every query head
    d, f, v, nq, nkv = 64, 128, 512, 64, 32
    mats = 3 if m["act"] == "silu_glu" else 2
    weights = layers * (2 * (d * (nq + 2 * nkv) + nq * d) + 2 * mats * d * f) + 2 * d * v
    acts = layers * 2 * B * ((d + nq) + 2 * (d + nkv) + (nq + d) + mats * (d + f)) \
        + 2 * B * (d + v)
    assert got.by_op["aten::mm"][1] == weights + acts
    per_layer_f32_kv = 2 * 4 * B * C * 4 * 16
    assert got.by_op["aten::bmm"][1] > layers * per_layer_f32_kv


def test_window_flops_add_up_over_rows():
    """The window's FLOPs are the per-token counts summed (`work.window_flops`)."""
    m = reduced("deepseek-coder-33b")

    class R:
        def __init__(self, n, k):
            self.prompt, self.max_new = [0] * n, k

    class Rnd:
        reqs = [R(5, 3), R(9, 2)]

        def times(self, i):
            return [1.0, 2.0, 3.0][:self.reqs[i].max_new]

    class W:
        rounds = [Rnd()]

        def inside(self, t):
            return t < 2.5
    per_layer = lambda fn, arg: sum(k(m, arg)[0] for k in fn)
    want = (per_layer([attn.prefill_work, dense_mlp.prefill_work], [5])
            + per_layer([attn.prefill_work, dense_mlp.prefill_work], [9])
            + per_layer([attn.decode_work, dense_mlp.decode_work], [6])
            + per_layer([attn.decode_work, dense_mlp.decode_work], [10])) * m["n_layers"] \
        + embed_head.work(m, 4)[0]
    assert work.window_flops(m, W()) == pytest.approx(want, rel=1e-12)
