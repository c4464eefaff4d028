"""The metric readers over a window that a small model served on the CPU,
each against the same quantity worked out here from the rounds."""
import time

import numpy as np
import pytest

from perfbench.harness import cli, loop, port, spec, traffic, weights, work
from perfbench.test_perfbench_faults import one_thread, tiny_mix, tiny_model  # noqa: F401

PEAKS = {"flops": 1e12, "bytes_per_s": 1e11}


class FakeTrace:
    window_s, busy_s = 2.0, 1.5

    def device_s(self, *spans):
        return 0.25 if spans else 0.0


@pytest.fixture(scope="module")
def window():
    """Three whole rounds and a fourth cut after two steps; the window
    closes as the cut round's third decode call enters."""
    m = tiny_model("nemotron15b.chat")
    w = weights.make(m, 11, "cpu")
    cfg = port.model_config(m)
    drv = loop.Driver(port.server(cfg, port.params(cfg, w), 4, "cpu"))
    stream = traffic.Stream(tiny_mix(), m["vocab"], 11, 4)
    t0 = t_send = time.perf_counter()
    rounds = []
    for _ in range(3):
        rounds.append(drv.serve(stream.take(4), t_send))
        t_send = rounds[-1].t_end
    drv.stop_after_steps = 2
    rounds.append(drv.serve(stream.take(4), t_send))
    return m, loop.Window(rounds, t0, rounds[-1].t_steps[-1])


def read(name, m, win, trace=None):
    run = cli.Run(m, win, 1.0, trace, PEAKS, None if trace is None else (trace, win))
    return spec.Spec().reader(name).read(run)


def test_counters(window):
    m, win = window
    done = [r for r in win.rounds if r.completions is not None]
    assert done and all(len(c.tokens) == q.max_new for r in done
                        for c, q in zip(r.completions, r.reqs))
    rows = dead = pads = total = 0
    for r, s, _ in win.decode_steps():
        rows += len(r.reqs)
        dead += sum(q.max_new <= s for q in r.reqs)
    for r in win.rounds:
        if win.inside(r.token_time(0)):
            total += r.bucket * len(r.reqs)
            pads += sum(r.bucket - len(q.prompt) for q in r.reqs)
    assert read("slot_waste", m, win) == pytest.approx(100 * dead / rows)
    assert read("pad_share", m, win) == pytest.approx(100 * pads / total)


def test_timings(window):
    m, win = window
    n = sum(win.inside(t) for r in win.rounds for i in range(len(r.reqs)) for t in r.times(i))
    assert read("out_tok_s", m, win) == pytest.approx(n / win.seconds)
    gaps = [b - a for r in win.rounds for i in range(len(r.reqs))
            for a, b in zip(r.times(i), r.times(i)[1:]) if win.inside(b)]
    assert read("itl_p95_ms", m, win) == pytest.approx(np.percentile(gaps, 95) * 1e3)
    firsts = [r.token_time(0) - r.t_send for r in win.rounds if win.inside(r.token_time(0))
              for _ in r.reqs]
    assert read("ttft_p95_ms", m, win) == pytest.approx(np.percentile(firsts, 95) * 1e3)
    steps = [r.token_time(s) - r.token_time(s - 1) for r in win.rounds
             for s in range(1, r.steps() + 1) if win.inside(r.token_time(s))]
    assert read("decode_step_ms", m, win) == pytest.approx(np.median(steps) * 1e3)
    assert read("setup_s", m, win) == 1.0


def test_shares(window):
    m, win = window
    assert read("mfu.chat", m, win) == pytest.approx(
        100 * work.window_flops(m, win) / (win.seconds * PEAKS["flops"]))
    assert read("idle_share.chat", m, win, FakeTrace()) == pytest.approx(25.0)
    assert read("idle_share.chat", m, win) is None
    bound = sum(work.kind_bound_s(m, "dense_mlp", "decode", work.live_lengths(r, s), PEAKS)
                for r in win.rounds for s in range(1, r.launched_steps() + 1))
    assert read("mlp_roofline.decode", m, win, FakeTrace()) == pytest.approx(100 * bound / 0.25)
    assert read("attn_roofline.prefill", m, win) is None
