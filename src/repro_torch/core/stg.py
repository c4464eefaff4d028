"""Streaming Task Graph (STG) intermediate representation.

The paper's front-end produces a feed-forward Kahn Process Network: composite
nodes joined by blocking FIFO channels.  Each node consumes ``in_rates[j]``
tokens per firing on input port ``j`` and produces ``out_rates[k]`` tokens on
output port ``k``.  Each node has a library of *implementations* with an area
cost ``A`` (number of primitive PEs) and an initiation interval ``II`` (cycles
per firing).  Inverse throughputs follow Eq. (1) of the paper:

    v_in(P)  = II(P) / In(f)
    v_out(P) = II(P) / Out(f)

Feedback cycles are rejected (the paper handles feed-forward STGs only).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field, replace
from fractions import Fraction
from typing import Any, Callable, Iterable, Sequence


@dataclass(frozen=True)
class Impl:
    """One implementation of a composite node.

    area: number of primitive PEs (paper: CLB-equivalent units).
    ii:   initiation interval, cycles between successive firings.
    latency: cycles from consuming inputs to producing outputs (>= ii).
    meta: free-form provenance (e.g. clustering decisions) for reporting.
    """

    name: str
    area: float
    ii: float
    latency: float | None = None
    meta: dict | None = None

    def __post_init__(self):
        if self.ii <= 0 or self.area < 0:
            raise ValueError(f"bad impl {self.name}: area={self.area} ii={self.ii}")
        if self.latency is None:
            object.__setattr__(self, "latency", float(self.ii))

    def v_in(self, in_rate: int) -> float:
        return self.ii / in_rate

    def v_out(self, out_rate: int) -> float:
        return self.ii / out_rate


# Node kinds.  FORK / JOIN are inserted by transforms (round-robin routing);
# they matter to the simulator and to area accounting.
COMPUTE, FORK, JOIN, SOURCE, SINK = "compute", "fork", "join", "source", "sink"


@dataclass
class Node:
    name: str
    impls: tuple[Impl, ...]
    in_rates: tuple[int, ...] = (1,)
    out_rates: tuple[int, ...] = (1,)
    kind: str = COMPUTE
    # Functional behaviour for the KPN simulator:
    #   fn(inputs: list[list[token]], state) -> (outputs: list[list[token]], state)
    # ``inputs[j]`` has exactly in_rates[j] tokens.  Pure nodes ignore state.
    fn: Callable | None = None
    init_state: Any = None

    def __post_init__(self):
        if not self.impls:
            raise ValueError(f"node {self.name} has no implementations")
        seen = set()
        for im in self.impls:
            if im.name in seen:
                raise ValueError(f"duplicate impl {im.name} in node {self.name}")
            seen.add(im.name)

    @property
    def n_in(self) -> int:
        return len(self.in_rates)

    @property
    def n_out(self) -> int:
        return len(self.out_rates)

    def impl(self, name: str) -> Impl:
        for im in self.impls:
            if im.name == name:
                return im
        raise KeyError(f"{self.name} has no impl {name}")

    def fastest(self) -> Impl:
        return min(self.impls, key=lambda im: (im.ii, im.area))

    def smallest(self) -> Impl:
        return min(self.impls, key=lambda im: (im.area, im.ii))

    def pareto(self) -> list[Impl]:
        """Implementations not dominated in (area, ii)."""
        out = []
        for im in sorted(self.impls, key=lambda im: (im.ii, im.area)):
            if not out or im.area < out[-1].area:
                out.append(im)
        return out


@dataclass(frozen=True)
class Channel:
    src: str
    dst: str
    src_port: int = 0
    dst_port: int = 0

    def key(self) -> tuple:
        return (self.src, self.src_port, self.dst, self.dst_port)


class STG:
    """A feed-forward streaming task graph (multirate SDF-style rates)."""

    def __init__(self, nodes: Iterable[Node] = (), channels: Iterable[Channel] = ()):
        self.nodes: dict[str, Node] = {}
        self.channels: list[Channel] = []
        for n in nodes:
            self.add_node(n)
        for c in channels:
            self.add_channel(c)

    # -- construction ------------------------------------------------------
    def add_node(self, node: Node) -> Node:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name}")
        self.nodes[node.name] = node
        return node

    def add_channel(self, ch: Channel) -> Channel:
        for end, port, n_ports in ((ch.src, ch.src_port, "n_out"), (ch.dst, ch.dst_port, "n_in")):
            if end not in self.nodes:
                raise ValueError(f"channel references unknown node {end}")
            if port >= getattr(self.nodes[end], n_ports):
                raise ValueError(f"channel {ch} port out of range on {end}")
        for other in self.channels:
            if (other.src, other.src_port) == (ch.src, ch.src_port):
                raise ValueError(f"output port reused: {ch}")
            if (other.dst, other.dst_port) == (ch.dst, ch.dst_port):
                raise ValueError(f"input port reused: {ch}")
        self.channels.append(ch)
        return ch

    def connect(self, src: str, dst: str, src_port: int = 0, dst_port: int = 0) -> Channel:
        return self.add_channel(Channel(src, dst, src_port, dst_port))

    def copy(self) -> "STG":
        g = STG()
        g.nodes = dict(self.nodes)
        g.channels = list(self.channels)
        return g

    # -- queries -----------------------------------------------------------
    def in_channels(self, name: str) -> list[Channel]:
        return sorted((c for c in self.channels if c.dst == name), key=lambda c: c.dst_port)

    def out_channels(self, name: str) -> list[Channel]:
        return sorted((c for c in self.channels if c.src == name), key=lambda c: c.src_port)

    def sources(self) -> list[str]:
        return [n for n in self.nodes if not self.in_channels(n)]

    def sinks(self) -> list[str]:
        return [n for n in self.nodes if not self.out_channels(n)]

    def topo_order(self) -> list[str]:
        # Heap-ordered Kahn: the order is the lexicographically-smallest
        # topological sort, independent of node-insertion order, so plans
        # and simulations are reproducible across graph constructions.
        indeg = {n: len(self.in_channels(n)) for n in self.nodes}
        ready = [n for n, d in indeg.items() if d == 0]
        heapq.heapify(ready)
        order: list[str] = []
        while ready:
            n = heapq.heappop(ready)
            order.append(n)
            for c in self.out_channels(n):
                indeg[c.dst] -= 1
                if indeg[c.dst] == 0:
                    heapq.heappush(ready, c.dst)
        if len(order) != len(self.nodes):
            raise ValueError("STG has feedback (cycle); the tool handles feed-forward graphs only")
        return order

    def validate(self) -> None:
        self.topo_order()
        # every non-source input port must be driven; every non-sink output used
        for name, node in self.nodes.items():
            ins = {c.dst_port for c in self.in_channels(name)}
            outs = {c.src_port for c in self.out_channels(name)}
            if ins and ins != set(range(node.n_in)):
                raise ValueError(f"{name}: input ports driven {ins} != 0..{node.n_in-1}")
            if outs and outs != set(range(node.n_out)):
                raise ValueError(f"{name}: output ports used {outs} != 0..{node.n_out-1}")

    # -- multirate balance (repetition vector) ------------------------------
    def repetition_vector(self) -> dict[str, int]:
        """Smallest positive integer firing counts q with, per channel,
        q[src] * out_rate == q[dst] * in_rate (SDF balance equations)."""
        q: dict[str, Fraction] = {}
        order = self.topo_order()
        if not order:
            return {}
        for name in order:
            if name not in q:
                q[name] = Fraction(1)
            for c in self.out_channels(name):
                produced = q[name] * self.nodes[name].out_rates[c.src_port]
                want = produced / self.nodes[c.dst].in_rates[c.dst_port]
                if c.dst in q:
                    if q[c.dst] != want:
                        raise ValueError(
                            f"inconsistent rates on {c}: {q[c.dst]} vs {want}")
                else:
                    q[c.dst] = want
        # verify channels whose dst was visited before src
        for c in self.channels:
            lhs = q[c.src] * self.nodes[c.src].out_rates[c.src_port]
            rhs = q[c.dst] * self.nodes[c.dst].in_rates[c.dst_port]
            if lhs != rhs:
                raise ValueError(f"rate mismatch on {c}: {lhs} != {rhs}")
        lcm = 1
        for f in q.values():
            lcm = lcm * f.denominator // math.gcd(lcm, f.denominator)
        out = {n: int(f * lcm) for n, f in q.items()}
        g = 0
        for v in out.values():
            g = math.gcd(g, v)
        return {n: v // g for n, v in out.items()}


@dataclass
class Selection:
    """A solution: per node, which implementation and how many replicas."""

    choices: dict[str, tuple[str, int]] = field(default_factory=dict)

    def impl_of(self, stg: STG, name: str) -> Impl:
        return stg.nodes[name].impl(self.choices[name][0])

    def replicas(self, name: str) -> int:
        return self.choices[name][1]

    def set(self, name: str, impl: str, nr: int = 1) -> "Selection":
        self.choices[name] = (impl, int(nr))
        return self

    def impl_area(self, stg: STG) -> float:
        return sum(stg.nodes[n].impl(i).area * nr for n, (i, nr) in self.choices.items())

    @classmethod
    def fastest(cls, stg: STG) -> "Selection":
        return cls({n: (stg.nodes[n].fastest().name, 1) for n in stg.nodes})

    @classmethod
    def smallest(cls, stg: STG) -> "Selection":
        return cls({n: (stg.nodes[n].smallest().name, 1) for n in stg.nodes})


def scale_impls(impls: Sequence[Impl], ratio: float,
                floor: float = 0.05) -> tuple[Impl, ...]:
    """Scale an implementation library's IIs (and latencies) by a measured
    /analytic throughput ratio — the single calibration rule shared by
    measurement-guided re-planning (runtime.pipeline.measure.calibrate and
    graphs.lm_graph.build_stg(ii_scale=...)).  ``floor`` guards against a
    noisy measurement collapsing an II toward zero."""
    r = max(floor, float(ratio))
    return tuple(replace(im, ii=im.ii * r, latency=(im.latency or im.ii) * r)
                 for im in impls)


def unit_rate_node(name: str, impls: Sequence[Impl], n_in: int = 1, n_out: int = 1,
                   fn: Callable | None = None, kind: str = COMPUTE,
                   init_state: Any = None) -> Node:
    return Node(name=name, impls=tuple(impls), in_rates=(1,) * n_in,
                out_rates=(1,) * n_out, fn=fn, kind=kind, init_state=init_state)
