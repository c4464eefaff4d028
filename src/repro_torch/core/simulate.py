"""Cycle-approximate KPN/STG simulator (paper §III.A).

Deterministic Kahn semantics: nodes block on their input FIFOs; a node fires
when every required input port holds a full rate-block of ready tokens and
the node's PE is free (``t >= next_free``); outputs become visible after the
implementation's latency and the PE is busy for II cycles.

JOIN nodes are the one (deterministic) exception to the all-ports rule: a
round-robin collector only needs its *scheduled* port (paper §II.B.2.c), and
the schedule is part of the node state, so determinism is preserved.

Used to validate (a) functional equivalence of transformed graphs (token
streams identical to the original graph's) and (b) that measured steady-state
inverse throughput matches the analytical model of `repro.core.throughput`.

Copied from ``repro/core/simulate.py``: plain Python and numpy, the names and
behaviour unchanged.
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field

from .stg import JOIN, SOURCE, STG, Selection


@dataclass
class SimResult:
    outputs: dict[str, list] = field(default_factory=dict)   # sink node -> tokens
    fire_times: dict[str, list[float]] = field(default_factory=dict)
    cycles: float = 0.0
    fired: dict[str, int] = field(default_factory=dict)

    def inverse_throughput(self, sink: str, warmup_frac: float = 0.25) -> float:
        """Steady-state cycles per firing at a sink (discard pipeline fill)."""
        times = self.fire_times[sink]
        if len(times) < 4:
            raise ValueError(f"too few firings at {sink} ({len(times)})")
        k = max(1, int(len(times) * warmup_frac))
        window = times[k:]
        return (window[-1] - window[0]) / (len(window) - 1)


def run(stg: STG, sel: Selection, inputs: dict[str, list], max_cycles: float = 1e9,
        max_firings: int = 1_000_000) -> SimResult:
    """Simulate until all source streams drain and no node can fire.

    inputs: per source-node token list (sources emit their stream with the
    selected implementation's II)."""
    res = SimResult()
    fifos: dict[tuple, deque] = {}
    for ch in stg.channels:
        fifos[ch.key()] = deque()
    in_chs = {n: stg.in_channels(n) for n in stg.nodes}
    out_chs = {n: stg.out_channels(n) for n in stg.nodes}
    state = {n: stg.nodes[n].init_state for n in stg.nodes}
    next_free = {n: 0.0 for n in stg.nodes}
    src_streams = {n: deque(toks) for n, toks in inputs.items()}
    for n in stg.nodes:
        res.fired[n] = 0
        res.fire_times[n] = []
        if not out_chs[n]:
            res.outputs[n] = []

    def ready_time(name: str, now_hint: float) -> float | None:
        """Earliest time >= next_free when the node can fire, or None."""
        node = stg.nodes[name]
        chans = in_chs[name]
        if not chans:  # source
            if name not in src_streams or not src_streams[name]:
                return None
            if len(src_streams[name]) < node.out_rates[0]:
                return None
            return next_free[name]
        if node.kind == JOIN:
            k = state[name] or 0
            ch = chans[k]
            need = node.in_rates[k]
            q = fifos[ch.key()]
            if len(q) < need:
                return None
            t = max(next_free[name], max(q[i][1] for i in range(need)))
            return t
        t = next_free[name]
        for ch in chans:
            need = node.in_rates[ch.dst_port]
            q = fifos[ch.key()]
            if len(q) < need:
                return None
            t = max(t, max(q[i][1] for i in range(need)))
        return t

    # Event loop: fire the earliest-ready node; ties broken by name for
    # determinism (result streams are schedule-independent by KPN property).
    heap: list[tuple[float, str]] = []
    for n in stg.nodes:
        t = ready_time(n, 0.0)
        if t is not None:
            heapq.heappush(heap, (t, n))
    total_fired = 0
    now = 0.0
    while heap and total_fired < max_firings:
        now, name = heapq.heappop(heap)
        if now > max_cycles:
            break
        t = ready_time(name, now)
        if t is None:
            continue
        if t > now:
            heapq.heappush(heap, (t, name))
            continue
        node = stg.nodes[name]
        impl = sel.impl_of(stg, name)
        # -- consume
        ins: list[list] = [[] for _ in range(max(1, node.n_in))]
        if in_chs[name]:
            if node.kind == JOIN:
                k = state[name] or 0
                q = fifos[in_chs[name][k].key()]
                ins[k] = [q.popleft()[0] for _ in range(node.in_rates[k])]
            else:
                for ch in in_chs[name]:
                    q = fifos[ch.key()]
                    ins[ch.dst_port] = [q.popleft()[0]
                                        for _ in range(node.in_rates[ch.dst_port])]
        else:
            ins[0] = [src_streams[name].popleft() for _ in range(node.out_rates[0])]
        # -- compute
        if node.fn is not None:
            outs, state[name] = node.fn(ins, state[name])
        elif not in_chs[name]:
            outs = [ins[0]]  # source passes its stream through
        else:
            # pass-through default; sinks record their consumed stream
            outs = [list(ins[0]) for _ in range(node.n_out)] if out_chs[name] else [list(ins[0])]
        # -- produce
        done = now + (impl.latency or impl.ii)
        if out_chs[name]:
            for ch in out_chs[name]:
                for tok in outs[ch.src_port]:
                    fifos[ch.key()].append((tok, done))
        else:
            for port_out in outs:
                res.outputs[name].extend(port_out)
        res.fired[name] += 1
        res.fire_times[name].append(now)
        total_fired += 1
        next_free[name] = now + impl.ii
        res.cycles = max(res.cycles, done)
        # -- reschedule this node and downstream consumers
        cand = [name] + [ch.dst for ch in out_chs[name]]
        for c in set(cand):
            t = ready_time(c, now)
            if t is not None:
                heapq.heappush(heap, (t, c))
    return res


def run_functional(stg: STG, sel: Selection, inputs: dict[str, list],
                   max_firings: int = 1_000_000) -> dict[str, list]:
    """Timing-free run; returns sink streams (KPN determinism makes this the
    canonical output for equivalence checks)."""
    return run(stg, sel, inputs, max_firings=max_firings).outputs
