"""The closed loop over ``LMServer.serve_round`` and the window's timeline.

As many clients as the cell's ``max_batch``; each sends its next request
as soon as its completion returns.  The server batches by rounds, so a
round takes one request from every client and returns all completions at
its end: round r + 1's requests are sent when round r returns (the first
round's at the window's start).

Every time is the host's clock (``time.perf_counter``), read as each call
into the model enters: the entry of decode call s + 1 follows the read of
step s's sampled tokens, which syncs with the device, so it is when step
s's tokens were delivered; the last step's tokens arrive when the round
returns.  The prefill's token is delivered when the first decode call
enters (or the round returns).  At the window's end the next call into
the model raises `WindowClosed`: the round in flight is cut, and what it
delivered before the end still counts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import port


class WindowClosed(Exception):
    """Raised from inside a round to end it at the window's close."""


@dataclass
class Round:
    reqs: list                      # traffic.Request
    bucket: int
    t_send: float
    t_prefill: float = float("nan")
    t_steps: list = field(default_factory=list)   # decode call entries
    t_end: float | None = None      # serve_round's return; None: cut
    completions: list | None = None

    def token_time(self, s: int) -> float | None:
        """When the round's token ``s`` (0: the prefill's) was delivered."""
        if s < len(self.t_steps):
            return self.t_steps[s]
        if s == len(self.t_steps) and self.t_end is not None:
            return self.t_end
        return None

    def times(self, i: int) -> list[float]:
        """The delivery times of request ``i``'s tokens that were delivered."""
        out = []
        for s in range(self.reqs[i].max_new):
            t = self.token_time(s)
            if t is None:
                break
            out.append(t)
        return out

    def steps(self) -> int:
        """Decode steps whose tokens were delivered."""
        n = len(self.t_steps) if self.t_end is None else len(self.t_steps) + 1
        return max(n - 1, 0)

    def launched_steps(self) -> int:
        """Decode steps launched on the device: every decode call's, less a
        cut round's last, which raised before it launched anything."""
        return len(self.t_steps) - (self.t_end is None)


def bucket_of(n: int, lo: int = 16) -> int:
    """The power-of-two bucket the server pads a round's prompts to."""
    b = lo
    while b < n:
        b *= 2
    return b


class Driver:
    """Drives one server through rounds; ``stop_at`` ends the window, and
    ``stop_after_steps`` cuts each round after that many decode calls."""

    def __init__(self, srv):
        self.srv = srv
        self.round: Round | None = None
        self.stop_at = float("inf")
        self.stop_after_steps: int | None = None
        port.wrap_model(srv, self._before_prefill, self._before_decode)

    def _before_prefill(self):
        now = time.perf_counter()
        if now >= self.stop_at:
            raise WindowClosed
        self.round.t_prefill = now

    def _before_decode(self):
        now = time.perf_counter()
        self.round.t_steps.append(now)
        if now >= self.stop_at or (self.stop_after_steps is not None
                                   and len(self.round.t_steps) > self.stop_after_steps):
            raise WindowClosed

    def serve(self, reqs, t_send: float) -> Round:
        rnd = Round(reqs, bucket_of(max(len(r.prompt) for r in reqs)), t_send)
        self.round = rnd
        try:
            with torch.profiler.record_function("LMServer.serve_round"):
                rnd.completions = self.srv.serve_round(port.requests(reqs))
            rnd.t_end = time.perf_counter()
        except WindowClosed:
            pass
        finally:
            self.round = None
        return rnd

    def closed_loop(self, stream, clients: int, t_start: float, t_stop: float,
                    after_round=None) -> list[Round]:
        """The window's rounds; ``after_round(rounds)`` runs as each round
        that was not cut returns, before the next is sent."""
        self.stop_at = t_stop
        rounds, t_send = [], t_start
        try:
            while time.perf_counter() < t_stop:
                rnd = self.serve(stream.take(clients), t_send)
                rounds.append(rnd)
                if rnd.t_end is None:
                    break
                if after_round is not None:
                    after_round(rounds)
                t_send = rnd.t_end
        finally:
            self.stop_at = float("inf")
        return rounds


@dataclass
class Window:
    """What the window served, for the metric readers."""
    rounds: list
    t_start: float
    t_stop: float

    @property
    def seconds(self) -> float:
        return self.t_stop - self.t_start

    def inside(self, t) -> bool:
        return t is not None and self.t_start <= t <= self.t_stop

    def delivered(self) -> int:
        return sum(self.inside(t) for r in self.rounds for i in range(len(r.reqs))
                   for t in r.times(i))

    def gaps(self) -> np.ndarray:
        """Every gap between consecutive tokens of a request, both inside."""
        out = []
        for r in self.rounds:
            for i in range(len(r.reqs)):
                ts = [t for t in r.times(i) if self.inside(t)]
                out.extend(np.diff(ts))
        return np.asarray(out, dtype=float)

    def ttfts(self) -> np.ndarray:
        """Send to first token, of every request whose first token came inside."""
        return np.asarray([r.token_time(0) - r.t_send for r in self.rounds
                           if self.inside(r.token_time(0)) for _ in r.reqs], dtype=float)

    def decode_steps(self):
        """(round, s, seconds) of each decode step s >= 1 delivered inside."""
        for r in self.rounds:
            for s in range(1, r.steps() + 1):
                t1, t0 = r.token_time(s), r.token_time(s - 1)
                if self.inside(t1):
                    yield r, s, t1 - t0

    def prefills(self):
        """(round, seconds) of each prefill whose token came inside."""
        for r in self.rounds:
            t = r.token_time(0)
            if self.inside(t):
                yield r, t - r.t_prefill
