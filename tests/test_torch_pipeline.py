"""The port's pipelined serving (`DecodePipeline` on the engine) on the CPU.

  * the engine's channels and diagnostics: the JAX package's unit tests
    of `StreamChannel`, held-slot release and deadlock detection, against
    the port's engine;
  * `DecodePipeline` against the port's single-device
    `LMServer(device="cpu", max_batch=group_size)` on the same `LM`, in
    float32: tokens identical and each group's last logits within 1e-6
    (the same ops on the same rows; only the CPU's matmul threading may
    differ), no first call inside the timed serve, and each decode op's
    host position equal to its cache's device ``pos``.  Models: ``tiny``,
    reduced h2o-danube-3-4b (sliding window: prompts and tokens past it,
    so the ring wraps) and reduced mamba2-370m with and without its MLP;
    fusion off, ``"auto"`` and an explicit partition; overlap on and off;
    one and two periods a stage;
  * the port's pipeline against the JAX `DecodePipeline(impl="ref")` on
    ``tiny`` with the same weights (``bridge.from_jax``), float32: logits
    within 1e-4 (two layers of float32 matmuls summed in another order by
    each framework, as in the model tests) at every step whose inputs
    agree, and tokens equal up to the first step whose top-2 margin is
    under ``TIE`` (random-init models have near-tie logits, where argmax
    may flip on differences below any tolerance).
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCfg as JaxShapeCfg
from repro.configs.tiny import CONFIG as jax_tiny
from repro.core import planner as jax_planner
from repro.graphs import lm_graph as jax_lm_graph
from repro.models import lm as jax_lm
from repro.runtime.pipeline import DecodePipeline as JaxDecodePipeline
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.core import planner
from repro_torch.core.verify import PlanVerificationError
from repro_torch.graphs import lm_graph
from repro_torch.models import lm
from repro_torch.runtime.pipeline import (AotProgram, CompileStats, DecodePipeline, Engine,
                                          Fifo, Op, StreamChannel, Tracer,
                                          registry_from_trace)
from repro_torch.runtime.server import LMServer, Request

MODELS = ["tiny", "h2o-danube-3-4b-smoke", "mamba2-370m-smoke", "mamba2-370m-smoke-no-mlp"]
LOGIT_TOL = 1e-6
JAX_TOL = 1e-4
TIE = 2e-4


# ===========================================================================
# stream channel and engine core (the JAX package's unit tests)
# ===========================================================================
def test_stream_channel_open_close_semantics():
    ch = StreamChannel(block=1, capacity_blocks=4)
    ch.push([(0, "a")], 0.0)
    assert not ch.exhausted
    ch.close()
    assert ch.closed and not ch.exhausted    # still a token to drain
    with pytest.raises(RuntimeError, match="after close"):
        ch.push([(1, "b")], 1.0)
    assert ch.pop(1) == [(0, "a")]
    assert ch.exhausted


def test_stream_channel_is_still_a_bounded_fifo():
    ch = StreamChannel(block=1, capacity_blocks=2)
    ch.push([1, 2], 0.0)
    assert not ch.can_push(1)
    with pytest.raises(OverflowError):
        ch.push([3], 0.0)


@pytest.mark.parametrize("overlap", [True, False])
def test_engine_releases_held_slots_when_op_raises(overlap):
    """An op whose body raises must not leak its channel credits: the
    engine frees op.releases on the failure path — pooled and inline
    execution alike — so the fifo returns to full capacity instead of
    wedging later consumers."""
    fifo = Fifo(block=1, capacity_blocks=2)
    fifo.push([(0, "x")], 0.0)

    class Consumer:
        name = "cons"
        n_replicas = 1

        def __init__(self):
            self.done = False

        def pending(self):
            return 0 if self.done else 1

        def peek(self):
            return None if self.done else Op(stage=0, kind="F", seq=0, rep=0)

        def ready(self, op, count_stall=False):
            return 0.0 if fifo.can_pop(1) else None

        def dispatch(self, op, driver):
            self.done = True
            fifo.pop_hold(1)
            op.releases.append((fifo, 1))

            def boom():
                raise RuntimeError("op body failed")
            return boom, ()

        def retire(self, op, result, engine):
            raise AssertionError("retire must not run for a failed op")

        def describe(self):
            return "cons"

    eng = Engine([Consumer()], overlap=overlap, workers=2)
    with pytest.raises(RuntimeError, match="op body failed"):
        eng.run()
    assert fifo.free == fifo.capacity


def test_engine_detects_deadlock_with_program_state():
    class Stuck:
        name = "stuck"
        n_replicas = 1

        def pending(self):
            return 1

        def peek(self):
            return Op(stage=0, kind="F", seq=0, rep=0)

        def ready(self, op, count_stall=False):
            return None             # forever blocked, nothing in flight

        def dispatch(self, op, driver):
            raise AssertionError

        def retire(self, *a):
            raise AssertionError

        def describe(self):
            return "stuck: 0/1"

    with pytest.raises(RuntimeError, match="deadlock.*stuck: 0/1"):
        Engine([Stuck()], overlap=False).run()


# ===========================================================================
# DecodePipeline against the port's single-device server
# ===========================================================================
def _config(name):
    """``<name>-no-mlp``: the config with ``d_ff=0``; float32 compute."""
    if name.endswith("-no-mlp"):
        return dataclasses.replace(get_config(name[:-7]), d_ff=0, compute_dtype="float32")
    return dataclasses.replace(get_config(name), compute_dtype="float32")


class _RecordingServer(LMServer):
    """The single-device server, keeping each round's last logits."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.round_logits = []

    def _sample(self, logits):
        self._last = logits
        return super()._sample(logits)

    def serve_round(self, reqs):
        out = super().serve_round(reqs)
        self.round_logits.append(self._last)
        return out


@functools.lru_cache(maxsize=None)
def _setup(name):
    """Config, graph, plan, weights, requests and the single-device
    server's completions and last logits a round.  The window config's
    prompts and tokens run past its window (64), so the ring wraps."""
    cfg = _config(name)
    shape = ShapeCfg("decode_test", 128, 16, "decode")
    plan = planner.plan(cfg, shape, chips=2 * cfg.n_layers + 4, max_tp=4)
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=4)
    params = lm.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    long = cfg.attn is not None and cfg.attn.window is not None
    lens = rng.integers(40, 100, 8) if long else rng.integers(3, 20, 8)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab, n).tolist(),
                    max_new=int(rng.integers(20, 30) if long else rng.integers(3, 9)))
            for i, n in enumerate(lens)]
    srv = _RecordingServer(cfg, max_batch=4, params=params, device="cpu")
    want = srv.serve(reqs)
    return cfg, stg, plan, params, reqs, want, srv.round_logits


def _base_names(cfg, pps):
    n = -(-cfg.n_periods // pps)
    return ["embed"] + [f"blocks{i:02d}" for i in range(n)] + ["head"]


def _refused(pipe):
    """Plans the serve's preflight refuses, as the JAX package's does: a
    fused stage holding several block stages (the heavy-set rule), or a
    single stage, whose ring of credits (the feedback stream alone) holds
    no more than the groups."""
    return len(pipe.stage_names) == 1 or any(
        sum(m.startswith("blocks") for m in g) > 1 for g in pipe.fusion_plan or ())


@pytest.mark.parametrize("pps", [1, 2])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("fusion", [None, "auto", "explicit"])
@pytest.mark.parametrize("name", MODELS)
def test_pipeline_matches_single_device_server(name, fusion, overlap, pps):
    cfg, stg, plan, params, reqs, want, want_logits = _setup(name)
    if fusion == "explicit":
        names = _base_names(cfg, pps)
        fusion = [tuple(names[:2]), tuple(names[2:])]
    pipe = DecodePipeline(cfg, stg, plan, device="cpu", params=params, overlap=overlap,
                          periods_per_stage=pps, fusion_plan=fusion)
    pipe.check_pos = True
    srv = LMServer(cfg, max_batch=4, pipeline=pipe, device="cpu")
    if _refused(pipe):
        with pytest.raises(PlanVerificationError):
            srv.serve(reqs)
        srv = LMServer(cfg, max_batch=4, pipeline=pipe, device="cpu", preflight=False)
    got = srv.serve(reqs)
    assert [c.uid for c in got] == [c.uid for c in want]
    assert [c.tokens for c in got] == [c.tokens for c in want]
    run = srv.last_run
    assert len(run.groups) == len(want_logits) == 2
    for g, logits in zip(run.groups, want_logits):
        torch.testing.assert_close(g.last_logits, logits, atol=LOGIT_TOL, rtol=0)
    assert pipe.compile_stats.late == 0 and pipe.compile_stats.calls > 0
    assert run.streams_used == 0                      # no CUDA stream on the CPU
    assert sum(run.stage_firings.values()) == len(run.op_trace) > 0
    if isinstance(fusion, list):
        assert pipe.stage_names == ["+".join(g) for g in fusion]
    stats = srv.stats.summary()
    assert stats["decode_tokens"] == sum(len(c.tokens) for c in want)
    assert set(stats["slo"]) >= {"ttft_p50_ms", "token_gap_p50_ms"}


def test_second_serve_runs_where_the_warm_up_ran():
    """The worker threads outlive a serve: a second overlapped serve runs
    every op on the thread and stream the warm-up ran it on, so it makes
    no first call at all."""
    cfg, stg, plan, params, reqs, want, _ = _setup("tiny")
    pipe = DecodePipeline(cfg, stg, plan, device="cpu", params=params)
    srv = LMServer(cfg, max_batch=4, pipeline=pipe, device="cpu")
    srv.serve(reqs)
    compiles = pipe.compile_stats.compiles
    assert [c.tokens for c in srv.serve(reqs)] == [c.tokens for c in want]
    assert (pipe.compile_stats.compiles, pipe.compile_stats.late) == (compiles, 0)
    pipe.close()


def test_first_call_on_an_unwarmed_thread_is_late():
    """A program warmed on one thread is not warm on another: PyTorch
    keeps a cuBLAS handle a thread, so that call counts as late."""
    prog = AotProgram(lambda p, x: x + p, stats=CompileStats())
    x = torch.zeros(3)
    prog.precompile(1.0, x)
    with prog.stats.window():
        prog(1.0, x)
        assert prog.stats.late == 0
        with ThreadPoolExecutor(1) as other:
            other.submit(prog, 1.0, x).result()
    assert (prog.stats.compiles, prog.stats.late) == (2, 1)


def test_stages_share_the_model_tensors():
    """Replicas and stages hold the `LM`'s tensors, not copies: block
    stages hold a slice of its layer list."""
    cfg, stg, plan, params, *_ = _setup("tiny")
    pipe = DecodePipeline(cfg, stg, plan, device="cpu", params=params, periods_per_stage=2)
    assert max(len(d) for d in pipe.stage_devices) > 1      # the plan replicates
    blocks = [s for s, span in enumerate(pipe.period_span) if span is not None]
    for s in blocks:
        lo = pipe.period_span[s][0] * len(cfg.block_pattern)
        assert pipe.stage_params[s]["layers"][0] is params.layers[lo]
    assert pipe.stage_params[0]["embed"] is params.embed
    head = params.embed if cfg.tie_embeddings else params.head
    assert pipe.stage_params[-1]["w"].data_ptr() == head.data_ptr()


def test_non_contiguous_fusion_plan_is_refused():
    cfg, stg, plan, params, *_ = _setup("tiny")
    with pytest.raises(ValueError, match="contiguous partition"):
        DecodePipeline(cfg, stg, plan, device="cpu", params=params,
                       fusion_plan=[("embed", "blocks01"), ("blocks00",), ("blocks02",),
                                    ("blocks03", "head")])


def test_temperature_sampling_is_seeded():
    cfg, stg, plan, params, reqs, *_ = _setup("tiny")
    runs = [DecodePipeline(cfg, stg, plan, device="cpu", params=params, seed=7,
                           temperature=0.8).serve([r.prompt for r in reqs], 5, group_size=4)
            for _ in range(2)]
    assert runs[0].tokens == runs[1].tokens
    assert all(0 <= t < cfg.padded_vocab for toks in runs[0].tokens for t in toks)


def test_traced_serve_reports_waits_and_metrics():
    cfg, stg, plan, params, reqs, want, _ = _setup("tiny")
    tracer = Tracer()
    srv = LMServer(cfg, max_batch=4, device="cpu", tracer=tracer,
                   pipeline=DecodePipeline(cfg, stg, plan, device="cpu", params=params))
    assert [c.tokens for c in srv.serve(reqs)] == [c.tokens for c in want]
    run = srv.last_run
    assert run.stage_wait_s and run.fifo_stats["feedback"].pushes > 0
    reg = registry_from_trace(tracer)
    assert reg.to_dict()


def test_entry_point_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg, stg, plan, params, *_ = _setup("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodePipeline(cfg, stg, plan)
    with pytest.raises(ValueError, match="params live on"):
        DecodePipeline(cfg, stg, plan, devices=["cpu"], params=lm.LM(cfg, device="meta"))


# ===========================================================================
# the port's pipeline against the JAX package's
# ===========================================================================
JAX_SHAPE = dict(name="decode_test", seq_len=64, global_batch=16, kind="decode")


def _prompts(vocab):
    rng = np.random.default_rng(11)      # one bucket (32) and one cap: one compile
    return [rng.integers(2, vocab, rng.integers(17, 32)).tolist() for _ in range(8)]


def _recording(pipe_sample, logits_of):
    """Wrap a pipeline's ``_sample`` to keep each group's logits in order."""
    def sample(logits, gid, temperature=None):
        if gid >= 0:                     # warm-up samples as gid -1
            logits_of.setdefault(gid, []).append(np.asarray(logits, np.float32)[:, -1])
        return pipe_sample(logits, gid, temperature)
    return sample


@pytest.fixture(scope="module")
def jax_pipeline_run():
    """One serve through the JAX pipeline (``impl="ref"``): its weights,
    tokens and the logits of every step of every group."""
    jcfg = dataclasses.replace(jax_tiny, compute_dtype="float32")
    shape = JaxShapeCfg(*JAX_SHAPE.values())
    plan = jax_planner.plan(jcfg, shape, chips=8, max_tp=4)
    stg, _ = jax_lm_graph.build_stg(jcfg, shape, max_tp=4)
    params = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    pipe = JaxDecodePipeline(jcfg, stg, plan, params=params, impl="ref", periods_per_stage=2)
    logits_of = {}
    pipe._sample = _recording(pipe._sample, logits_of)
    run = pipe.serve(_prompts(jcfg.vocab), 6, group_size=4)
    return jax.tree.map(np.array, params), run.tokens, logits_of


def test_pipeline_matches_jax_pipeline(jax_pipeline_run):
    tree, want_tokens, want_logits = jax_pipeline_run
    cfg = dataclasses.replace(get_config("tiny"), compute_dtype="float32")
    shape = ShapeCfg(*JAX_SHAPE.values())
    plan = planner.plan(cfg, shape, chips=8, max_tp=4)
    stg, _ = lm_graph.build_stg(cfg, shape, max_tp=4)
    pipe = DecodePipeline(cfg, stg, plan, device="cpu", periods_per_stage=2,
                          params=bridge.from_jax(cfg, tree, device="cpu"))
    logits_of = {}
    pipe._sample = _recording(pipe._sample, logits_of)
    run = pipe.serve(_prompts(cfg.vocab), 6, group_size=4)
    assert sorted(logits_of) == sorted(want_logits) == [0, 1]
    parted = {}                          # request -> first step it may part at
    for gid in want_logits:
        for step, (got, want) in enumerate(zip(logits_of[gid], want_logits[gid])):
            np.testing.assert_allclose(got, want, atol=JAX_TOL, rtol=0)
            top2 = np.sort(want, axis=-1)[:, -2:]
            flips = np.flatnonzero(got.argmax(-1) != want.argmax(-1))
            assert all(top2[i, 1] - top2[i, 0] < TIE for i in flips), (gid, step, flips)
            if len(flips):               # the next step's inputs differ
                for i in range(len(got)):
                    parted[4 * gid + i] = step
                break
    for r, (got, want) in enumerate(zip(run.tokens, want_tokens)):
        n = parted.get(r, len(want))
        assert got[:n] == want[:n], (r, got, want)
        if r not in parted:
            assert got == want
