"""Spans around the calls into the program's layers, and the reading of a
``torch.profiler`` trace of the window.

Spans are ``torch.profiler.record_function`` ranges that the benchmark
puts around calls at run time (`patched`), editing no file of the
program: ``LMServer.serve_round`` and ``lm.prefill`` / ``lm.decode_step``
always (`loop`), and whatever the cell's per-layer readers name in their
``SPANS``.  A target that is missing fails the run.

A device operation's time belongs to the spans that were open on the host
when it was launched: the launch is the CUDA runtime call that shares its
correlation id, and its host time and thread place it among the spans
(`Trace.device_s`).  Busy time is the union of the device operations'
intervals (the method of ``repro_torch.probes.busy``); the window is the
profiler's, on the host's clock.  Recording the host's operations slows
the host's side of a step several times over, so busy and idle time come
from a stretch that records the device alone (`Traced`), and the spans'
device time from the stretch after it.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass

import torch

from . import port

TOP = 10
NAME_CHARS = 120


@contextlib.contextmanager
def patched(spans: dict):
    """Wrap each target ``"module:Class.attr"`` of ``spans`` (span name ->
    target) in a span of its name while the block runs."""
    saved = []
    try:
        for name, target in spans.items():
            owner, attr = port.resolve(target)
            orig = owner.__dict__[attr] if attr in vars(owner) else getattr(owner, attr)
            saved.append((owner, attr, orig))

            def spanned(*a, _orig=orig, _name=name, **kw):
                with torch.profiler.record_function(_name):
                    return _orig(*a, **kw)
            setattr(owner, attr, spanned)
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


class Profiled:
    """One profiled stretch of the window, in whole rounds: from its start
    (the window's, or between two rounds) to the return of the first round
    that ends ``seconds`` or more after it, or to the window's close.  With
    ``spans`` the host's operations and the spans are recorded beside the
    device's (for the device time in each span); else the device alone,
    which adds no host work to the steps (for busy and idle time)."""

    def __init__(self, seconds: float, sync, spans: bool):
        self.seconds, self.sync = seconds, sync
        self.prof = profiler(spans)
        self.t0 = self.window_s = None
        self.first = self.last = 0        # the window's rounds[first:last]

    @property
    def running(self) -> bool:
        return self.t0 is not None and self.window_s is None

    def start(self, first: int) -> None:
        """Profile from here, the window's ``first`` round on; the stretch's
        time starts once the profiler has started (it takes seconds)."""
        self.prof.start()
        self.t0, self.first = time.perf_counter(), first

    def after_round(self, rounds) -> bool:
        """Whether the round that just returned ended this stretch."""
        if self.running and rounds[-1].t_end - self.t0 >= self.seconds:
            self.stop(rounds)
            return True
        return False

    def stop(self, rounds) -> None:
        if self.running:
            self.sync()
            self.window_s = time.perf_counter() - self.t0
            self.last = len(rounds)
            self.prof.stop()


class Traced:
    """A traced run's two stretches, one after the other: the device alone
    (`device`), then the device with the spans (`spans`).  Every round
    serves the same block of sizes, so a few rounds stand for the window,
    and each trace stays small enough to read in seconds."""

    def __init__(self, seconds: float, sync):
        self.device = Profiled(seconds, sync, spans=False)
        self.spans = Profiled(seconds, sync, spans=True)

    def start(self) -> None:
        self.device.start(0)

    def after_round(self, rounds) -> None:
        if self.device.running:
            if self.device.after_round(rounds):
                self.spans.start(len(rounds))
        else:
            self.spans.after_round(rounds)

    def stop(self, rounds) -> None:
        self.device.stop(rounds)
        self.spans.stop(rounds)


def profiler(spans: bool = True):
    acts = [torch.profiler.ProfilerActivity.CPU] if spans else []
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts or [torch.profiler.ProfilerActivity.CPU],
                                  record_shapes=False, with_stack=False, profile_memory=False)


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: int
    by_path: dict          # tuple of open span names at launch -> device seconds
    device_ops: list       # [[kernel name, seconds]], most first
    idle_gaps: list        # [[host activity, seconds]], most first

    def device_s(self, *names: str) -> float:
        """Device seconds of operations launched inside spans ``names``, each
        nested in the one before (not necessarily directly)."""
        total = 0.0
        for path, sec in self.by_path.items():
            it = iter(path)
            if all(n in it for n in names):
                total += sec
        return total


def _stacks(annotations, queries):
    """For each query (time, thread), the names of the spans open on that
    thread at that time, outermost first."""
    evs = []
    for k, (s, e, name, th) in enumerate(annotations):
        evs.append((th, s, 0, k))
        evs.append((th, e, 2, k))
    for q, (t, th) in enumerate(queries):
        evs.append((th, t, 1, q))
    evs.sort()
    out = [()] * len(queries)
    stack, thread = [], None
    for th, _, what, k in evs:
        if th != thread:
            stack, thread = [], th
        if what == 0:
            stack.append(k)
        elif what == 2:
            if k in stack:
                stack.remove(k)
        else:
            out[k] = tuple(annotations[j][2] for j in stack)
    return out


def read(prof, window_s: float, span_names) -> Trace:
    """The trace of ``prof`` (a stopped profiler) over a window of
    ``window_s`` host seconds; raises if no operation ran on the device."""
    span_names = set(span_names)
    annotations, launches, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        on_device = str(e.device_type()).endswith("CUDA")
        if e.is_user_annotation():
            if not on_device and e.name() in span_names:
                annotations.append((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id()))
        elif on_device:
            ops.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
        elif e.name().startswith("cu"):
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
    if not ops:
        raise RuntimeError("the profiler recorded no operation on the device in the window")
    ops.sort()
    queries = [launches.get(c, (s, -1)) for s, _, _, c in ops]
    # the host thread that ran the spans, for naming idle gaps
    main = max(set(a[3] for a in annotations), default=-1,
               key=lambda th: sum(a[3] == th for a in annotations))
    busy, gaps, end = 0, [], None
    last = None
    for s, e, name, _ in ops:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s - end, last))
            busy += e - s
            end, last = e, name
        elif e > end:
            busy += e - end
            end, last = e, name
    stacks = _stacks(annotations, queries + [(t, main) for t, _, _ in gaps])
    by_path, by_name = defaultdict(float), defaultdict(float)
    for (s, e, name, _), path in zip(ops, stacks):
        by_path[path] += (e - s) / 1e9
        by_name[name[:NAME_CHARS]] += (e - s) / 1e9
    idle = defaultdict(float)
    for (_, length, before), path in zip(gaps, stacks[len(ops):]):
        idle[path[-1] if path else f"after {before[:NAME_CHARS]}"] += length / 1e9
    idle["before the first and after the last operation"] += max(
        window_s - (ops[-1][1] - ops[0][0]) / 1e9, 0.0)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Trace(window_s=window_s, busy_s=busy / 1e9, ops=len(ops), by_path=dict(by_path),
                 device_ops=top(by_name), idle_gaps=top(idle))
