"""Reading a profiler trace: busy time as the union of device operations,
each operation's time given to the spans open when it was launched, and
idle gaps named by what the host was doing (`harness.trace.read`)."""
import pytest

from perfbench.harness import trace


class Dev:
    def __init__(self, name):
        self.name = name

    def __str__(self):
        return f"DeviceType.{self.name}"


class Ev:
    def __init__(self, name, dev, start, end, corr=0, thread=1, annotation=False):
        self._v = (name, Dev(dev), start, end, corr, thread, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


class Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


SPANS = ["LMServer.serve_round", "lm.decode_step", "blocks.MLP.forward"]


def events():
    return [
        Ev("LMServer.serve_round", "CPU", 0, 1000, annotation=True),
        Ev("lm.decode_step", "CPU", 100, 500, annotation=True),
        Ev("blocks.MLP.forward", "CPU", 200, 300, annotation=True),
        Ev("other annotation", "CPU", 210, 220, annotation=True),
        Ev("aten::mm", "CPU", 240, 260, corr=12),
        Ev("cudaLaunchKernel", "CPU", 150, 151, corr=11),
        Ev("cudaLaunchKernel", "CPU", 250, 251, corr=12),
        Ev("cudaLaunchKernel", "CPU", 600, 601, corr=13),
        Ev("k1", "CUDA", 200, 260, corr=11),
        Ev("k2", "CUDA", 300, 400, corr=12),
        Ev("k2", "CUDA", 380, 450, corr=99),
        Ev("k3", "CUDA", 700, 800, corr=13),
        Ev("blocks.MLP.forward", "CUDA", 300, 400, annotation=True),
    ]


def test_busy_paths_and_gaps():
    t = trace.read(Prof(events()), 1e-6, SPANS)
    assert t.ops == 4
    assert t.busy_s == pytest.approx((60 + 150 + 100) * 1e-9)
    assert t.device_s("lm.decode_step", "blocks.MLP.forward") == pytest.approx(100e-9)
    assert t.device_s("lm.decode_step") == pytest.approx(160e-9)
    assert t.device_s("LMServer.serve_round") == pytest.approx(260e-9)
    assert t.device_s("blocks.MLP.forward", "lm.decode_step") == 0
    assert t.by_path[()] == pytest.approx(70e-9)         # launched by no known call
    assert t.device_ops[0] == ["k2", pytest.approx(170e-9)]
    idle = dict(t.idle_gaps)
    assert idle["blocks.MLP.forward"] == pytest.approx(40e-9)
    assert idle["lm.decode_step"] == pytest.approx(250e-9)
    assert idle["before the first and after the last operation"] == pytest.approx(400e-9)


def test_an_empty_trace_fails():
    with pytest.raises(RuntimeError):
        trace.read(Prof([Ev("lm.decode_step", "CPU", 0, 9, annotation=True)]), 1.0, SPANS)


def test_traced_stretches_are_whole_rounds_one_after_the_other():
    """The device alone is traced up to the first round that ends past the
    stretch's seconds, then the spans from there on, up to the next such
    round; each keeps which of the window's rounds it saw."""
    import time
    from types import SimpleNamespace
    t = trace.Traced(1.0, lambda: None)
    t.start()
    t0 = t.device.t0
    rounds = []
    for end in (0.5, 1.5):
        rounds.append(SimpleNamespace(t_end=t0 + end))
        t.after_round(rounds)
    assert (t.device.first, t.device.last) == (0, 2) and t.device.window_s is not None
    assert t.spans.running and t.spans.first == 2
    for end in (2.0, 2.2, 3.5, 4.0):
        rounds.append(SimpleNamespace(t_end=t.spans.t0 + end - 1.5))
        t.after_round(rounds)
    t.stop(rounds)
    assert (t.spans.first, t.spans.last) == (2, 5)


def test_idle_gaps_outside_spans_are_named_by_the_operation_before():
    evs = [Ev("k1", "CUDA", 0, 100, corr=1), Ev("k2", "CUDA", 150, 200, corr=2)]
    t = trace.read(Prof(evs), 200e-9, [])
    assert dict(t.idle_gaps)["after k1"] == pytest.approx(50e-9)
