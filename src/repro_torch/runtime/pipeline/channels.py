"""Bounded FIFO channels: a host queue with backpressure.

Copied from ``repro/runtime/pipeline/channels.py``: `Fifo` and
`StreamChannel`, with the names and behaviour unchanged.  Real
inter-stage buffers hold a couple of rate-blocks (double buffering: the
consumer drains block ``i`` while the producer fills ``i+1``), and a full
buffer *stalls the producer* (backpressure), so a plan whose stage rates
are mismatched shows the stall where it would really happen instead of
growing a queue without bound.

Under asynchronous dispatch a slot is occupied from the moment the
producer's op is *dispatched* until the consumer's op that ate the token
*completes* on the device: ``reserve()`` claims a slot at producer
dispatch, ``push_reserved()`` fills it, ``pop_hold()`` hands the token to
the consumer while keeping the slot occupied, and ``release()`` frees it
at consumer retirement.  Capacity therefore bounds total in-flight work
(queued + executing) per edge: device memory cannot grow without bound no
matter how far ahead the host runs.  An optional ``prefetch_fn`` stages
the first ``prefetch_depth`` queued tokens ahead of their pop (a copy to
the consumer's device); on one card there is nothing to stage.

A queued token is an activation that the producer no longer writes: the
stage programs update only their own resident caches in place, never a
tensor that crosses a FIFO.

Tokens are timestamped with their *visibility* time; capacity is counted
in rate-blocks of the consumer's port rate.  Stall/occupancy/prefetch
counters feed the measurement layer.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass


@dataclass
class FifoStats:
    pushes: int = 0
    pops: int = 0
    producer_stalls: int = 0      # firings deferred because the fifo was full
    high_water: int = 0           # max tokens resident in the host queue
    inflight_high_water: int = 0  # max slots occupied incl. reserved + held
    prefetches: int = 0           # tokens staged on device ahead of pop


class Fifo:
    """Bounded FIFO of (token, ready_time) with block-granular accounting.

    ``block`` is the consumer's port rate (tokens consumed per firing);
    ``capacity_blocks`` defaults to 2 — double buffering.  ``prefetch_fn``
    (token -> token), when set, is applied to at most ``prefetch_depth``
    tokens at the head of the queue ahead of their pop — a copy to the
    consumer's device, issued early.
    """

    # set via `trace.Tracer.watch_fifo`: a watched fifo emits an
    # occupancy counter event on every push/pop (class-level None keeps
    # the unwatched hot path to one attribute load per operation)
    tracer = None
    label: str | None = None

    def __init__(self, block: int = 1, capacity_blocks: int = 2,
                 min_capacity: int = 0, prefetch_fn=None,
                 prefetch_depth: int = 1):
        """``min_capacity`` floors the token capacity — rate-changing
        channels need room for the *producer's* burst (out_rate tokens per
        firing), which can exceed consumer-block sizing."""
        if block < 1 or capacity_blocks < 1:
            raise ValueError(f"bad fifo shape: block={block} "
                             f"capacity_blocks={capacity_blocks}")
        self.block = block
        self.capacity = max(block * capacity_blocks, min_capacity)
        self.prefetch_fn = prefetch_fn
        self.prefetch_depth = max(0, prefetch_depth)
        self._q: deque = deque()
        self._reserved = 0        # slots claimed by dispatched producers
        self._held = 0            # slots kept by executing consumers
        self._prefetched = 0      # head tokens already staged on device
        self.stats = FifoStats()

    def __len__(self) -> int:
        return len(self._q)

    @property
    def inflight_slots(self) -> int:
        """Slots occupied beyond the queue itself (producer-reserved +
        consumer-held) — the device-side in-flight work on this edge."""
        return self._reserved + self._held

    @property
    def free(self) -> int:
        return self.capacity - len(self._q) - self._reserved - self._held

    def can_push(self, n: int) -> bool:
        return self.free >= n

    # -- producer side ------------------------------------------------------
    def reserve(self, n: int) -> None:
        """Claim ``n`` slots at producer *dispatch* time (async path); fill
        them with ``push_reserved`` when the tokens materialise."""
        if not self.can_push(n):
            raise OverflowError(
                f"fifo overflow: reserving {n} of {self.free} free slots — "
                f"producer dispatched without space (backpressure bug)")
        self._reserved += n
        self._note_inflight()

    def push_reserved(self, tokens, ready_time: float) -> None:
        """Fill previously reserved slots (completion of an async push)."""
        if len(tokens) > self._reserved:
            raise OverflowError(
                f"push_reserved of {len(tokens)} exceeds {self._reserved} "
                f"reserved slots")
        self._reserved -= len(tokens)
        self._append(tokens, ready_time)

    def push(self, tokens, ready_time: float) -> None:
        if not self.can_push(len(tokens)):
            raise OverflowError(
                f"fifo overflow: pushing {len(tokens)} into {self.free} free "
                f"slots — producer fired without space (backpressure bug)")
        self._append(tokens, ready_time)

    def _append(self, tokens, ready_time: float) -> None:
        for t in tokens:
            self._q.append((t, ready_time))
        self.stats.pushes += len(tokens)
        self.stats.high_water = max(self.stats.high_water, len(self._q))
        if self.tracer is not None:
            self.tracer.fifo_event("push", self.label or "fifo",
                                   len(self._q))
        self._note_inflight()
        self._maybe_prefetch()

    # -- consumer side ------------------------------------------------------
    def can_pop(self, n: int | None = None) -> bool:
        return len(self._q) >= (self.block if n is None else n)

    def ready_time(self, n: int | None = None) -> float | None:
        """Visibility time of the n-th oldest token (None if not present)."""
        n = self.block if n is None else n
        if len(self._q) < n:
            return None
        return max(self._q[i][1] for i in range(n))

    def pop(self, n: int | None = None) -> list:
        n = self.block if n is None else n
        if len(self._q) < n:
            raise IndexError(f"fifo underflow: want {n}, have {len(self._q)}")
        self.stats.pops += n
        self._prefetched = max(0, self._prefetched - n)
        out = [self._q.popleft()[0] for _ in range(n)]
        if self.tracer is not None:
            self.tracer.fifo_event("pop", self.label or "fifo",
                                   len(self._q))
        self._maybe_prefetch()
        return out

    def pop_hold(self, n: int | None = None) -> list:
        """Pop tokens but keep their slots occupied until ``release`` —
        the consumer's op is dispatched but not yet complete, so the edge's
        in-flight budget still owns this work."""
        n = self.block if n is None else n
        out = self.pop(n)
        self._held += n
        self._note_inflight()
        return out

    def release(self, n: int) -> None:
        """Free slots held by ``pop_hold`` (consumer op retired)."""
        if n > self._held:
            raise ValueError(f"release of {n} exceeds {self._held} held slots")
        self._held -= n
        self._maybe_prefetch()

    def note_stall(self) -> None:
        self.stats.producer_stalls += 1

    # -- device staging ------------------------------------------------------
    def _maybe_prefetch(self) -> None:
        """Stage head tokens on device.  A raising ``prefetch_fn`` leaves
        the queue consistent: the failing token stays un-staged and
        poppable, nothing is dropped, and no slot accounting moved — the
        exception propagates to the caller, but the channel cannot leak
        capacity or wedge its consumers."""
        if self.prefetch_fn is None:
            return
        while self._prefetched < min(len(self._q), self.prefetch_depth):
            tok, t = self._q[self._prefetched]
            staged = self.prefetch_fn(tok)      # may raise: state untouched
            self._q[self._prefetched] = (staged, t)
            self._prefetched += 1
            self.stats.prefetches += 1

    def _note_inflight(self) -> None:
        occ = len(self._q) + self._reserved + self._held
        self.stats.inflight_high_water = max(
            self.stats.inflight_high_water, occ)


class StreamChannel(Fifo):
    """A Fifo carrying an *open-ended* token stream.

    Microbatch pipelines know their traffic up front (a fixed list of
    microbatches -> a fixed op schedule); serving pipelines do not — decode
    tokens keep arriving as long as any request slot is live, and the
    consumer must distinguish "empty right now" (more tokens coming; keep
    polling) from "ended" (the producer closed the stream; drain and
    stop).  The decode pipeline's head->embed feedback edge is the
    canonical user: sampled tokens stream back continuously until every
    serving slot hits EOS or its budget, then the head closes the stream.

    ``close()`` is the producer-side end-of-stream marker; pushing after
    close is a protocol error.  ``exhausted`` is the consumer-side
    termination test (closed *and* drained).
    """

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.closed = False

    def close(self) -> None:
        self.closed = True

    @property
    def exhausted(self) -> bool:
        return self.closed and not len(self._q)

    def _append(self, tokens, ready_time: float) -> None:
        if self.closed:
            raise RuntimeError(
                f"push of {len(tokens)} token(s) after close() — the "
                f"producer declared end-of-stream")
        super()._append(tokens, ready_time)
