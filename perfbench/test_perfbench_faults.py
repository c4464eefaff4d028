"""A whole run of the harness on the CPU, at small widths, with the timed
path broken underneath: ``correct`` has to come out false for each fault
a served cell can have, and true for the sound program.  Every finished
request is compared here, so a fault in any row is in the sample.  The
exchange between chips has no fault to plant: every cell runs on one."""
import copy
import time

import pytest

from perfbench.harness import cli, spec

CELLS = [w["name"] for w in spec.Spec().bench["workloads"]]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the runs are timed windows, and the test workers
    share the cores."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny_model(cell: str) -> dict:
    s = spec.Spec()
    m = copy.deepcopy(s.config(s.cell(cell)["config"])["model"])
    m.update(n_layers=2, d_model=64, d_ff=128, vocab=512)
    m["attn"].update(n_heads=4, n_kv_heads=2, head_dim=16)
    return m


def tiny_settings() -> dict:
    """The chat cell's limits over every finished request of a small batch."""
    chk = spec.Spec().cell_settings("nemotron15b.chat")["check"]
    return {"max_batch": 4, "check": {**chk, "tokens": 10 ** 6, "max_requests": 10 ** 6,
                                      "min_tokens": 1}}


def tiny_mix() -> dict:
    """Short prompts and longer outputs, so that a round takes milliseconds
    on a loaded CPU and the served tokens are much of each context: a step
    that loses its state then serves other tokens."""
    return {"loop": "closed", "pair_seed": 3,
            "prompt_len": {"dist": "uniform", "min": 4, "max": 16},
            "output_len": {"dist": "uniform", "min": 16, "max": 40}}


def run(cell: str, seconds: float = 3.0) -> dict:
    return cli.run_cell(spec.Spec(), cell, 2 ** 31 + 99, seconds, False, "cpu",
                        time.perf_counter(), model=tiny_model(cell), settings=tiny_settings(),
                        mix=tiny_mix())


def _state_unchanged(monkeypatch):
    """Each decode step hands back the cache as it found it."""
    from repro_torch.models import lm
    step = lm.decode_step

    def frozen(cfg, params, cache, tokens, **kw):
        saved = [{k: v.clone() for k, v in c.items()} for c in cache["layers"]]
        pos = cache["pos"].clone()
        logits, cache = step(cfg, params, cache, tokens, **kw)
        for c, s in zip(cache["layers"], saved):
            for k, v in s.items():
                c[k].copy_(v)
        cache["pos"].copy_(pos)
        return logits, cache
    monkeypatch.setattr(lm, "decode_step", frozen)


def _half_batch(monkeypatch):
    """Half of the rows left out of each step, given the mean of the rest."""
    from repro_torch.models import lm
    step = lm.decode_step

    def half(cfg, params, cache, tokens, **kw):
        logits, cache = step(cfg, params, cache, tokens, **kw)
        h = logits.shape[0] // 2
        logits[h:] = logits[:h].mean(dim=0, keepdim=True)
        return logits, cache
    monkeypatch.setattr(lm, "decode_step", half)


def _token_altered(monkeypatch):
    """One row's sampled token changed where the server samples it."""
    from repro_torch.runtime import server
    sample = server.LMServer._sample

    def altered(self, logits):
        out = sample(self, logits).clone()
        out[0] = (out[0] + 1) % logits.shape[-1]
        return out
    monkeypatch.setattr(server.LMServer, "_sample", altered)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["check"]
    assert res["check"]["compared_tokens"]["value"] > 0
    assert list(res["metrics"]) == [m["name"] for m in spec.Spec().metrics(cell, False)]
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run(cell)
    assert res["check"]["compared_tokens"]["value"] > 0
    assert not res["correct"], res["check"]


def test_missing_span_target_fails():
    from perfbench.harness import trace
    with pytest.raises(AttributeError):
        with trace.patched({"x": "repro_torch.models.blocks:Attention.no_such_call"}):
            pass


def test_spans_are_put_back():
    from repro_torch.models import blocks

    from perfbench.harness import trace
    before = blocks.MLP.forward
    with trace.patched({"blocks.MLP.forward": "repro_torch.models.blocks:MLP.forward"}):
        assert blocks.MLP.forward is not before
    assert blocks.MLP.forward is before


@pytest.mark.parametrize("cell", CELLS)
def test_control_separates(cell):
    """The control (the reference computed in fp8 in the program's place),
    judged by the run's own comparison with the cell's own batch, mix and
    sample on a round that the sound program served, at small widths: its
    mean gap reads at least three times the program's, and with limits set
    between the two readings as the cells' are (60% of the way up from the
    program's), the program is correct and the control is not.  At the
    cells' own sizes `calibrate.py` judges the control on the card against
    the cells' own limits (PERF.md)."""
    from perfbench.harness import check, loop, port, traffic, weights
    s = spec.Spec()
    settings = s.cell_settings(cell)
    mix = s.traffic(s.cell(cell)["traffic"])
    m = tiny_model(cell)
    w = weights.make(m, 2 ** 31 + 5, "cpu")
    cfg = port.model_config(m)
    drv = loop.Driver(port.server(cfg, port.params(cfg, w), settings["max_batch"], "cpu"))
    clients = settings["max_batch"]
    rnd = drv.serve(traffic.Stream(mix, m["vocab"], 5, clients).take(clients),
                    time.perf_counter())
    program = check.compare(m, w, [rnd], 5, settings, "cpu")
    control = check.compare(m, w, [rnd], 5, settings, "cpu", control="fp8")
    assert control["compared_tokens"] == program["compared_tokens"]
    assert control["mean_gap"] >= 3 * program["mean_gap"]
    at_size = {"check": {**settings["check"], **{
        f"{k}_limit": program[k] + 0.6 * (control[k] - program[k])
        for k in ("logit_gap", "mean_gap")}}}
    assert check.passed(check.held(program, at_size)), program
    assert not check.passed(check.held(control, at_size)), control
