"""Graph transforms: materialise a Selection as an explicit replicated STG.

Replication semantics (paper §II.B.2.c): ``nr`` replicas of a node receive
tokens round-robin and their outputs are collected round-robin, preserving
the original stream order (KPN determinism).  When the fan between producer
and consumer replica groups exceeds ``nf``, explicit FORK/JOIN tree nodes
are inserted.

Round-robin tree indexing: a fork tree over ``nd = nf^H`` leaves routes token
``t`` along its little-endian base-nf digits, so leaf index == t mod nd —
exact round-robin with no permutation.  Join trees mirror the construction.
The simulator (`repro.core.simulate`) verifies functional equivalence of the
transformed graph against the original.

Copied from ``repro/core/transform.py``: plain Python and numpy, the names and
behaviour unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from .fork_join import ForkJoinModel, LITERAL
from .stg import COMPUTE, FORK, JOIN, STG, Channel, Impl, Node, Selection


def _fork_fn(n_out: int):
    def fn(inputs, state):
        k = state or 0
        outs = [[] for _ in range(n_out)]
        outs[k].extend(inputs[0])  # one block to the scheduled output
        return outs, (k + 1) % n_out
    return fn


def _join_fn(n_in: int):
    def fn(inputs, state):
        # fires with one block on exactly one input (the scheduled one);
        # the simulator's JOIN firing rule only requires that port.
        k = state or 0
        return [list(inputs[k])], (k + 1) % n_in
    return fn


def _fork_node(name: str, n_out: int, fj: ForkJoinModel, block: int = 1) -> Node:
    return Node(name=name, kind=FORK,
                impls=(Impl("fork", area=fj.node_area, ii=float(block)),),
                in_rates=(block,), out_rates=(block,) * n_out,
                fn=_fork_fn(n_out), init_state=0)


def _join_node(name: str, n_in: int, fj: ForkJoinModel, block: int = 1) -> Node:
    return Node(name=name, kind=JOIN,
                impls=(Impl("join", area=fj.node_area, ii=float(block)),),
                in_rates=(block,) * n_in, out_rates=(block,),
                fn=_join_fn(n_in), init_state=0)


@dataclass
class ReplicatedGraph:
    stg: STG
    selection: Selection            # per materialised node (replicas -> 1)
    replica_map: dict[str, list[str]] = field(default_factory=dict)
    fork_join_nodes: list[str] = field(default_factory=list)

    def overhead_area(self) -> float:
        return sum(self.stg.nodes[n].impls[0].area for n in self.fork_join_nodes)


def _build_fork_tree(g: STG, sel: Selection, fj: ForkJoinModel, src: str,
                     src_port: int, dests: list[tuple[str, int]],
                     tag: str, created: list[str], block: int = 1) -> None:
    """Connect one producer output to len(dests) destinations round-robin."""
    fan = len(dests)
    if fan == 1:
        g.connect(src, dests[0][0], src_port, dests[0][1])
        return
    f = _fork_node(f"{tag}.fork", min(fan, fj.nf), fj, block)
    g.add_node(f)
    created.append(f.name)
    sel.set(f.name, "fork", 1)
    g.connect(src, f.name, src_port, 0)
    if fan <= fj.nf:
        for k, (d, dp) in enumerate(dests):
            g.connect(f.name, d, k, dp)
        return
    # split dests into nf groups by digit (t mod nf) — little-endian routing
    groups: list[list[tuple[str, int]]] = [[] for _ in range(fj.nf)]
    for t, d in enumerate(dests):
        groups[t % fj.nf].append(d)
    for k, grp in enumerate(groups):
        _build_fork_tree(g, sel, fj, f.name, k, grp, f"{tag}.{k}", created, block)


def _build_join_tree(g: STG, sel: Selection, fj: ForkJoinModel,
                     srcs: list[tuple[str, int]], dst: str, dst_port: int,
                     tag: str, created: list[str], block: int = 1) -> None:
    fan = len(srcs)
    if fan == 1:
        g.connect(srcs[0][0], dst, srcs[0][1], dst_port)
        return
    j = _join_node(f"{tag}.join", min(fan, fj.nf), fj, block)
    g.add_node(j)
    created.append(j.name)
    sel.set(j.name, "join", 1)
    if fan <= fj.nf:
        for k, (s, sp) in enumerate(srcs):
            g.connect(s, j.name, sp, k)
        g.connect(j.name, dst, 0, dst_port)
        return
    groups: list[list[tuple[str, int]]] = [[] for _ in range(fj.nf)]
    for t, s in enumerate(srcs):
        groups[t % fj.nf].append(s)
    for k, grp in enumerate(groups):
        _build_join_tree(g, sel, fj, grp, j.name, k, f"{tag}.{k}", created, block)
    g.connect(j.name, dst, 0, dst_port)


def materialize(stg: STG, sel: Selection, fj: ForkJoinModel = LITERAL) -> ReplicatedGraph:
    """Expand a Selection into an explicit graph with replicas + fork/join.

    Requires replica counts on connected nodes to divide each other (the
    heuristic produces nf-aligned counts); raises otherwise.
    """
    g = STG()
    out_sel = Selection()
    rmap: dict[str, list[str]] = {}
    created: list[str] = []

    for name, node in stg.nodes.items():
        impl_name, nr = sel.choices[name]
        names = [name] if nr == 1 else [f"{name}@{k}" for k in range(nr)]
        rmap[name] = names
        for rn in names:
            g.add_node(Node(name=rn, impls=(node.impl(impl_name),),
                            in_rates=node.in_rates, out_rates=node.out_rates,
                            kind=node.kind, fn=node.fn, init_state=node.init_state))
            out_sel.set(rn, impl_name, 1)

    for ch in stg.channels:
        s_reps, d_reps = rmap[ch.src], rmap[ch.dst]
        ns, nd = len(s_reps), len(d_reps)
        tag = f"{ch.src}.{ch.src_port}->{ch.dst}.{ch.dst_port}"
        out_rate = stg.nodes[ch.src].out_rates[ch.src_port]
        in_rate = stg.nodes[ch.dst].in_rates[ch.dst_port]
        if (ns > 1 or nd > 1) and out_rate != in_rate:
            raise ValueError(
                f"replication across rate-changing channel {tag} "
                f"({out_rate}->{in_rate}) is not supported; re-block the graph")
        block = in_rate
        if nd >= ns:
            if nd % ns:
                raise ValueError(f"replica counts not aligned on {tag}: {ns}->{nd}")
            gsize = nd // ns
            for i, s in enumerate(s_reps):
                dests = [(d_reps[i + j * ns], ch.dst_port) for j in range(gsize)]
                _build_fork_tree(g, out_sel, fj, s, ch.src_port, dests,
                                 f"{tag}#{i}", created, block)
        else:
            if ns % nd:
                raise ValueError(f"replica counts not aligned on {tag}: {ns}->{nd}")
            gsize = ns // nd
            for i, d in enumerate(d_reps):
                srcs = [(s_reps[i + j * nd], ch.src_port) for j in range(gsize)]
                _build_join_tree(g, out_sel, fj, srcs, d, ch.dst_port,
                                 f"{tag}#{i}", created, block)

    g.validate()
    return ReplicatedGraph(g, out_sel, rmap, created)
