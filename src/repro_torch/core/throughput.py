"""Throughput analysis and propagation (paper §II.B.2.a/b, Eq. 1, 5, 6, 7).

All quantities are *inverse throughputs* (cycles per token), written ``v``.
Replication divides a node's effective inverse throughput: ``nr`` round-robin
replicas of an implementation with inverse throughput ``v`` sustain ``v / nr``.

Per channel (Eq. 5):   slack  v_s = v_mo - v_ei
  v_mo : producer's minimum output inverse throughput on the channel,
  v_ei : consumer's expected input inverse throughput on the channel.
A channel with v_s > 0 starves its consumer (producer is the bottleneck);
v_s < 0 means the consumer cannot keep up (consumer is the bottleneck).

Per node (Eq. 6):      weight W_m = (sum_out v_s - sum_in v_s) / (N_in + N_out)
High weight == critical bottleneck.

Propagation (Eq. 7):   v_out^k = min_j { v_in^j * In^j } / Out^k
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .stg import STG, Channel, Selection


@dataclass
class ChannelRates:
    channel: Channel
    v_mo: float   # producer min output inverse throughput (cycles/token)
    v_ei: float   # consumer expected input inverse throughput
    slack: float  # Eq. 5


@dataclass
class Analysis:
    channels: dict[tuple, ChannelRates] = field(default_factory=dict)
    weights: dict[str, float] = field(default_factory=dict)
    v_app: float = 0.0                 # application inverse throughput (cycles/graph iteration, normalised)
    cycles_per_iteration: float = 0.0  # max_m q_m * II_m / nr_m
    bottleneck: str | None = None
    node_iter_time: dict[str, float] = field(default_factory=dict)

    def ranked_bottlenecks(self) -> list[str]:
        return sorted(self.weights, key=lambda n: -self.weights[n])


def node_v_out(stg: STG, sel: Selection, name: str, port: int) -> float:
    impl = sel.impl_of(stg, name)
    nr = sel.replicas(name)
    return impl.ii / (stg.nodes[name].out_rates[port] * nr)


def node_v_in(stg: STG, sel: Selection, name: str, port: int) -> float:
    impl = sel.impl_of(stg, name)
    nr = sel.replicas(name)
    return impl.ii / (stg.nodes[name].in_rates[port] * nr)


def analyze(stg: STG, sel: Selection) -> Analysis:
    """Full-graph throughput analysis under a selection (Eq. 1, 5, 6)."""
    a = Analysis()
    q = stg.repetition_vector()
    # Per-node steady-state time per graph iteration.
    for name, node in stg.nodes.items():
        impl = sel.impl_of(stg, name)
        a.node_iter_time[name] = q[name] * impl.ii / sel.replicas(name)
    a.cycles_per_iteration = max(a.node_iter_time.values()) if a.node_iter_time else 0.0
    a.v_app = a.cycles_per_iteration

    for ch in stg.channels:
        v_mo = node_v_out(stg, sel, ch.src, ch.src_port)
        v_ei = node_v_in(stg, sel, ch.dst, ch.dst_port)
        a.channels[ch.key()] = ChannelRates(ch, v_mo, v_ei, v_mo - v_ei)

    for name, node in stg.nodes.items():
        ins = stg.in_channels(name)
        outs = stg.out_channels(name)
        s_in = sum(a.channels[c.key()].slack for c in ins)
        s_out = sum(a.channels[c.key()].slack for c in outs)
        denom = max(1, len(ins) + len(outs))
        a.weights[name] = (s_out - s_in) / denom  # Eq. 6

    a.bottleneck = max(a.node_iter_time, key=lambda n: a.node_iter_time[n]) if a.node_iter_time else None
    return a


def propagate_targets(stg: STG, v_tgt: float) -> dict[str, float]:
    """Propagate an application-level inverse-throughput target to every node
    (Eq. 7).  ``v_tgt`` is the inverse throughput demanded on each source
    node's input stream.  Returns, per node, the target inverse throughput
    *per firing* (i.e. the maximum II/nr the node may have)."""
    order = stg.topo_order()
    # Target v on each channel, keyed by channel key.
    chan_v: dict[tuple, float] = {}
    firing_v: dict[str, float] = {}
    for name in order:
        node = stg.nodes[name]
        ins = stg.in_channels(name)
        if ins:
            # Eq. 7 numerator: min over input channels of v_in^j * In^j.
            per_firing = min(chan_v[c.key()] * node.in_rates[c.dst_port] for c in ins)
        else:
            per_firing = v_tgt * node.in_rates[0] if node.in_rates else v_tgt
        firing_v[name] = per_firing
        for c in stg.out_channels(name):
            chan_v[c.key()] = per_firing / node.out_rates[c.src_port]  # Eq. 7
    return firing_v


def min_replicas(ii: float, v_firing_target: float) -> int:
    """Replicas needed so ii / nr <= target (Eq. 8 generalised)."""
    import math
    if v_firing_target <= 0:
        raise ValueError("target must be positive")
    return max(1, math.ceil(ii / v_firing_target - 1e-12))
