"""The port's checkpoints and its fault-tolerant training loop, on the CPU.

The checkpoint tests follow ``tests/test_data_checkpoint.py`` on the
port's module; the loop tests are ``tests/test_system.py``'s seven trainer
tests run on the port (``train_loop`` / ``run_resilient`` on
qwen2.5-3b ``reduced()`` with ``device="cpu"``): a crash and restart is
invisible in the loss curve and in the final parameters (bitwise), two
crashes complete, a crash before the first checkpoint restarts from
scratch, too many failures raise, a seed gives the same curve, a stall is
flagged as a straggler, and the loss falls on the bigram task.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, list_steps,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.launch import train as train_cli
from repro_torch.runtime.failures import FailureInjector, SimulatedNodeFailure
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime import failures as failures_mod
from repro_torch.runtime import trainer as trainer_mod
from repro_torch.runtime.trainer import TrainLoopConfig, run_resilient, train_loop

CFG = get_config("qwen2.5-3b").reduced()


@pytest.fixture(autouse=True)
def one_thread():
    """The loop tests run beside other test workers: one torch thread a
    worker keeps them from crowding the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# -- checkpoints -------------------------------------------------------------
def _tree(step, value=None):
    return {"params": {"w": torch.full((3, 4), float(step if value is None else value)),
                       "layers.0.norm": torch.arange(4, dtype=torch.float32),
                       "h": torch.ones(2, dtype=torch.bfloat16) * step},
            "opt_state": {"m": {"w": torch.zeros(3, 4)}},
            "step": np.int64(step)}


def test_save_restore_roundtrip_bitwise(tmp_path):
    save_checkpoint(tmp_path, 10, _tree(10), metadata={"cfg": "x"})
    tree, meta = restore_checkpoint(tmp_path, _tree(0))
    assert meta["step"] == 10 and meta["metadata"] == {"cfg": "x"}
    assert torch.equal(tree["params"]["w"], _tree(10)["params"]["w"])
    assert tree["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(tree["params"]["h"], _tree(10)["params"]["h"])
    assert int(tree["step"]) == 10 and tree["step"].dtype == np.int64
    paths = json.loads((tmp_path / "step-10" / "meta.json").read_text())["paths"]
    assert "params/layers.0.norm" in paths and "opt_state/m/w" in paths


def test_latest_and_retention(tmp_path):
    for s in (5, 10, 15, 20, 25):
        save_checkpoint(tmp_path, s, _tree(s), keep=3)
    assert latest_step(tmp_path) == 25
    assert list_steps(tmp_path) == [15, 20, 25]


def test_keep_every_milestones(tmp_path):
    for s in range(10, 60, 10):
        save_checkpoint(tmp_path, s, _tree(s), keep=2, keep_every=30)
    assert set(list_steps(tmp_path)) == {30, 40, 50}


def test_torn_checkpoint_is_invisible(tmp_path):
    save_checkpoint(tmp_path, 1, _tree(1))
    torn = tmp_path / ".tmp-2-123-456"          # a writer died before the rename
    torn.mkdir()
    (torn / "shard-00000.npz").write_bytes(b"partial")
    assert list_steps(tmp_path) == [1]
    tree, meta = restore_checkpoint(tmp_path, _tree(0))
    assert meta["step"] == 1


def test_restore_shape_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path, 1, _tree(1))
    like = _tree(0)
    like["params"]["w"] = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, like)


def test_restore_missing_leaf_raises(tmp_path):
    save_checkpoint(tmp_path, 1, _tree(1))
    like = _tree(0)
    like["params"]["extra"] = torch.zeros(2)
    with pytest.raises(ValueError, match="missing"):
        restore_checkpoint(tmp_path, like)


def test_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path, _tree(0))


def test_async_checkpointer_orders_and_drains(tmp_path):
    with AsyncCheckpointer(tmp_path, keep=5) as ck:
        for s in (1, 2, 3):
            ck.save(s, _tree(s))
    assert list_steps(tmp_path) == [1, 2, 3]
    assert ck.saved_steps == [1, 2, 3]


def test_async_snapshot_isolated_from_later_mutation(tmp_path):
    """``save`` copies to the host before it returns: an in-place update of
    the parameters right after it cannot reach the write."""
    tree = _tree(1)
    with AsyncCheckpointer(tmp_path) as ck:
        ck.save(1, tree)
        tree["params"]["w"].add_(1000.0)
    restored, _ = restore_checkpoint(tmp_path, _tree(0))
    assert float(restored["params"]["w"].max()) == 1.0


def test_no_temporary_directories_left_behind(tmp_path):
    for s in (1, 2):
        save_checkpoint(tmp_path, s, _tree(s))
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp")]


# -- the training loop (tests/test_system.py's, on the port) ---------------
def _loop(tmp, **kw):
    base = dict(steps=10, seq_len=32, global_batch=4, ckpt_dir=str(tmp), ckpt_interval=4,
                log_interval=1, warmup=4, lr=1e-3)
    base.update(kw)
    return TrainLoopConfig(**base)


def _params(summary):
    return {k: p.detach() for k, p in summary.model.named_parameters()}


def test_crash_restart_is_transparent(tmp_path):
    """The same loss curve and, bitwise, the same final parameters with and
    without a crash at step 6 (checkpoint at 4, deterministic replay)."""
    clean = train_loop(CFG, _loop(tmp_path / "clean"), device="cpu")
    failed = run_resilient(CFG, _loop(tmp_path / "fail", failures=FailureInjector({6: "crash"})),
                           max_restarts=2, device="cpu")
    assert failed["restarts"] == 1
    assert failed["final_step"] == clean.final_step == 10
    assert failed["summaries"][-1].restored_from == 4
    overlap = set(clean.losses) & set(failed["losses"])
    assert len(overlap) >= 4
    for s in overlap:
        assert failed["losses"][s] == clean.losses[s]
    want, got = _params(clean), _params(failed["summaries"][-1])
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_two_crashes_still_complete(tmp_path):
    out = run_resilient(CFG, _loop(tmp_path, failures=FailureInjector({3: "crash", 7: "crash"})),
                        max_restarts=3, device="cpu")
    assert out["restarts"] == 2
    assert out["final_step"] == 10


def test_crash_before_first_checkpoint_restarts_from_scratch(tmp_path):
    out = run_resilient(CFG, _loop(tmp_path, failures=FailureInjector({2: "crash"})),
                        max_restarts=1, device="cpu")
    assert out["final_step"] == 10
    assert out["summaries"][-1].restored_from is None


def test_too_many_failures_raises(tmp_path):
    with pytest.raises(SimulatedNodeFailure):
        run_resilient(CFG, _loop(tmp_path, failures=FailureInjector({3: "crash", 5: "crash"})),
                      max_restarts=1, device="cpu")


def test_seed_determinism(tmp_path):
    a = train_loop(CFG, _loop(tmp_path / "a", seed=11), device="cpu")
    b = train_loop(CFG, _loop(tmp_path / "b", seed=11), device="cpu")
    c = train_loop(CFG, _loop(tmp_path / "c", seed=12), device="cpu")
    assert a.losses == b.losses
    assert a.losses != c.losses


class _StepClock:
    """A clock for the loop: each read advances it 10 ms and each sleep by
    its length, so a step takes 10 ms plus its stall whatever the load of
    the machine running the test."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 0.01
        return self.now

    def sleep(self, seconds):
        self.now += seconds


def test_straggler_flagged_and_median_stable(tmp_path, monkeypatch):
    """The stalled step, and it alone, is flagged, timed on `_StepClock`
    (the loop times its steps and the injector stalls through the module
    attribute ``time``)."""
    clock = _StepClock()
    monkeypatch.setattr(trainer_mod, "time", clock)
    monkeypatch.setattr(failures_mod, "time", clock)
    mon = StragglerMonitor(threshold=3.0)
    train_loop(CFG, _loop(tmp_path, steps=12, failures=FailureInjector({8: "stall:0.6"}),
                          straggler=mon), device="cpu")
    assert [e.step for e in mon.events] == [8]
    assert mon.events[0].duration == pytest.approx(0.61)
    assert mon.median < 0.3          # the stall did not poison the median


def test_loss_decreases_on_bigram(tmp_path):
    s = train_loop(CFG, _loop(tmp_path, steps=40, ckpt_interval=0, lr=3e-3, warmup=10),
                   device="cpu")
    first = s.losses[min(s.losses)]
    assert s.final_loss < first - 0.1


def test_multi_device_options_raise(tmp_path):
    """``tp > 1`` and ``fsdp`` train over `local_mesh`, which needs the
    default process group: without one they raise, naming the way in
    (`tests/test_torch_distributed.py` trains with them)."""
    for kw in ({"tp": 2}, {"fsdp": True}):
        with pytest.raises(RuntimeError, match="init_distributed"):
            train_loop(CFG, _loop(tmp_path, **kw), device="cpu")


def test_train_cli_on_the_cpu(tmp_path, capsys):
    train_cli.main(["--arch", "tiny", "--device", "cpu", "--steps", "3", "--seq-len", "16",
                    "--global-batch", "2", "--metrics", str(tmp_path / "m.jsonl")])
    assert "done: 3 steps" in capsys.readouterr().out
    recs = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 2]
    train_cli.main(["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu", "--steps", "4",
                    "--seq-len", "16", "--global-batch", "2", "--ckpt-dir", str(tmp_path / "c"),
                    "--ckpt-interval", "2", "--fail-at", "3:crash", "--max-restarts", "1"])
    text = capsys.readouterr().out
    out = json.loads(text[text.index("{"):])
    assert out["restarts"] == 1 and out["final_step"] == 4
    assert list_steps(tmp_path / "c") == [2, 4]
