"""Stage combining & splitting: plan-level rewrites of an STG + Selection.

The paper's signature move beyond implementation selection + replication is
*restructuring* the graph itself: **combining** adjacent nodes into one
(deleting the FIFO between them and its fork/join routing overhead) and
**splitting** a bottleneck node at an internal cut-point into two pipelined
halves (unlocking finer placement).  ``core/transform.py`` materializes
replication; this module materializes the other two axes, in the same
shape as hwtHls's netlist transformation passes: a semantics-preserving
graph rewrite, validated structurally, that downstream layers (planner,
placement, executors) consume unchanged.

``combine(stg, sel, names)`` merges a contiguous linear chain of nodes
into one node whose chosen implementation is the *sequential composition*
of the members' chosen implementations:

    II(fused)      = sum of member IIs        (one firing does all the work)
    area(fused)    = sum of member areas      (the deleted FIFO / fork-join
                                               overhead is charged per
                                               *channel* by the cost models,
                                               so it disappears with the
                                               internal channel)
    latency(fused) = sum of member latencies

The fused impl's ``meta`` records the member nodes and choices exactly, so
``split`` of a combined node restores the originals bit-for-bit —
``split(combine(a, b)) == (a, b)`` on IIs, areas, and impl libraries.
``split`` of a *plain* node takes a declared cut fraction and produces two
pipelined halves whose IIs/areas/latencies partition the original's; the
halves carry ``split_of`` provenance so ``combine(split(x)) == x``.

``auto_fusion`` is the planner-side scorer: it enumerates contiguous
partitions of a stage chain and ranks them on the virtual clock with
measured per-stage host dispatch cost folded in as a per-stage fixed cost
(the ``measured_ratio``-style calibration loop).  The structural guard is
the ``heavy`` set — stages that own pipeline state (KV-cache period spans)
may not fuse with each other, because merging them is the planner's
``periods_per_stage`` axis, not fusion; fusion's job is absorbing the
stateless endpoint stages (embed, head) into their neighbours, which
deletes their dispatch + FIFO hop without moving any resident state.
"""
from __future__ import annotations

from dataclasses import dataclass

from .stg import COMPUTE, STG, Channel, Impl, Node, Selection


@dataclass
class RestructuredGraph:
    """An STG + Selection after a combine/split rewrite.

    ``groups`` maps rewritten names: for ``combine``, fused name -> the
    member names it replaced; for ``split``, original name -> the part
    names that replaced it.  ``deleted_channels`` are the internal FIFOs
    a combine removed (their fork/join overhead disappears with them).
    """

    stg: STG
    selection: Selection
    groups: dict[str, tuple[str, ...]]
    deleted_channels: tuple[Channel, ...] = ()


def _chain_channels(stg: STG, names: list[str]) -> list[Channel]:
    """The internal channels of a contiguous linear chain, validated."""
    internal = []
    for a, b in zip(names, names[1:]):
        ab = [c for c in stg.channels if c.src == a and c.dst == b]
        if len(ab) != 1:
            raise ValueError(f"combine: expected exactly one channel {a}->{b}, "
                             f"found {len(ab)}")
        if [c.key() for c in stg.out_channels(a)] != [ab[0].key()]:
            raise ValueError(f"combine: {a} has outputs besides {a}->{b}; "
                             "members must form a linear chain")
        if [c.key() for c in stg.in_channels(b)] != [ab[0].key()]:
            raise ValueError(f"combine: {b} has inputs besides {a}->{b}; "
                             "members must form a linear chain")
        internal.append(ab[0])
    return internal


def _compose_fns(members: list[Node]):
    """Sequential composition of member KPN functions (None if any member
    is analytic-only).  State is the tuple of member states."""
    if any(m.fn is None for m in members):
        return None, None
    init = tuple(m.init_state for m in members)

    def fn(inputs, state):
        state = list(state)
        toks = inputs
        for i, m in enumerate(members):
            toks, state[i] = m.fn(toks, state[i])
        return toks, tuple(state)

    return fn, init


def _split_parent(sel: Selection, stg: STG, names: list[str]):
    """If ``names`` are exactly the parts of one earlier split (in order),
    return the (node, impl_name, nr) to restore; else None."""
    metas = []
    for n in names:
        im = sel.impl_of(stg, n)
        if not im.meta or "split_of" not in im.meta:
            return None
        metas.append(im.meta["split_of"])
    node0, impl0, nr0, _, n_parts = metas[0]
    if n_parts != len(names):
        return None
    for i, (node, impl, nr, idx, total) in enumerate(metas):
        if node is not node0 or idx != i or total != n_parts:
            return None
    return node0, impl0, nr0


def combine(stg: STG, sel: Selection, names, *,
            fused_name: str | None = None) -> RestructuredGraph:
    """Merge a contiguous linear chain of nodes into one node.

    Members must be given in chain order, each internal boundary must be a
    single channel with no side edges, all members must fire at the same
    repetition count, and the Selection must give them equal replica
    counts (the fused node gets one replica count).  Combining the parts
    of an earlier ``split`` restores the original node exactly.
    """
    names = list(names)
    if len(names) < 2:
        raise ValueError("combine needs at least two members")
    for n in names:
        if n not in stg.nodes:
            raise KeyError(f"combine: unknown node {n}")
        if stg.nodes[n].kind != COMPUTE:
            raise ValueError(f"combine: {n} is {stg.nodes[n].kind}, "
                             "only compute nodes combine")
    internal = _chain_channels(stg, names)
    q = stg.repetition_vector()
    if len({q[n] for n in names}) != 1:
        raise ValueError(f"combine: members fire at different repetition "
                         f"counts {[q[n] for n in names]}")
    nrs = {sel.replicas(n) for n in names}
    if len(nrs) != 1:
        raise ValueError(f"combine: members have different replica counts "
                         f"{sorted(nrs)}; align replication first")
    nr = nrs.pop()

    restored = _split_parent(sel, stg, names)
    if restored is not None:
        node, impl_name, _ = restored
        fused = node
        choice = (impl_name, nr)
    else:
        members = [stg.nodes[n] for n in names]
        chosen = [sel.impl_of(stg, n) for n in names]
        fn, init = _compose_fns(members)
        impl = Impl(
            name="+".join(im.name for im in chosen),
            area=sum(im.area for im in chosen),
            ii=sum(im.ii for im in chosen),
            latency=sum(im.latency for im in chosen),
            meta={"members": tuple(names),
                  "member_nodes": tuple(members),
                  "member_choices": tuple(sel.choices[n] for n in names),
                  "internal_channels": tuple(internal)})
        fused = Node(name=fused_name or "+".join(names), impls=(impl,),
                     in_rates=members[0].in_rates,
                     out_rates=members[-1].out_rates,
                     kind=COMPUTE, fn=fn, init_state=init)
        choice = (impl.name, nr)

    new = STG()
    member_set = set(names)
    for n, node in stg.nodes.items():
        if n not in member_set:
            new.add_node(node)
    new.add_node(fused)
    internal_keys = {c.key() for c in internal}
    for c in stg.channels:
        if c.key() in internal_keys:
            continue
        src = fused.name if c.src in member_set else c.src
        dst = fused.name if c.dst in member_set else c.dst
        new.add_channel(Channel(src, dst, c.src_port, c.dst_port))

    new_sel = Selection({n: v for n, v in sel.choices.items()
                         if n not in member_set})
    new_sel.set(fused.name, *choice)
    rg = RestructuredGraph(stg=new, selection=new_sel,
                           groups={fused.name: tuple(names)},
                           deleted_channels=tuple(internal))
    validate_restructure(stg, rg, touched=member_set | {fused.name})
    return rg


def split(stg: STG, sel: Selection, name: str, *, cut: float = 0.5,
          part_names: tuple[str, str] | None = None) -> RestructuredGraph:
    """Cut one node into two pipelined halves.

    A node produced by ``combine`` is restored to its exact members
    (``split(combine(a, b)) == (a, b)`` on IIs/areas/impls).  A plain node
    is cut at the declared internal point ``cut`` in (0, 1): the first
    half gets ``cut`` of the II/area/latency, the second the rest; both
    carry ``split_of`` provenance so a later ``combine`` restores the
    original exactly.  Fresh halves are analytic-only (``fn=None`` — a
    black-box kernel has no functional midpoint); the restored form keeps
    the original ``fn``.
    """
    if name not in stg.nodes:
        raise KeyError(f"split: unknown node {name}")
    node = stg.nodes[name]
    chosen = sel.impl_of(stg, name)
    nr = sel.replicas(name)

    if chosen.meta and "member_nodes" in chosen.meta:
        parts = list(chosen.meta["member_nodes"])
        choices = list(chosen.meta["member_choices"])
        internal = list(chosen.meta["internal_channels"])
    else:
        if not (0.0 < cut < 1.0):
            raise ValueError(f"split: cut={cut} must be in (0, 1)")
        a, b = part_names or (f"{name}.0", f"{name}.1")
        fracs = (cut, 1.0 - cut)
        parts, choices = [], []
        for i, (pn, fr) in enumerate(zip((a, b), fracs)):
            im = Impl(name=chosen.name, area=chosen.area * fr,
                      ii=chosen.ii * fr, latency=chosen.latency * fr,
                      meta={"split_of": (node, chosen.name, nr, i, 2)})
            # the halves stream at the original rates on the cut channel:
            # the first half keeps the node's input signature, the second
            # its output signature, and one unit-rate channel joins them.
            parts.append(Node(name=pn, impls=(im,),
                              in_rates=node.in_rates if i == 0 else (1,),
                              out_rates=(1,) if i == 0 else node.out_rates,
                              kind=COMPUTE))
            choices.append((chosen.name, nr))
        internal = [Channel(a, b)]

    new = STG()
    for n, nd in stg.nodes.items():
        if n != name:
            new.add_node(nd)
    for p in parts:
        new.add_node(p)
    head, tail = parts[0].name, parts[-1].name
    for c in stg.channels:
        if c.dst == name:
            new.add_channel(Channel(c.src, head, c.src_port, c.dst_port))
        elif c.src == name:
            new.add_channel(Channel(tail, c.dst, c.src_port, c.dst_port))
        else:
            new.add_channel(c)
    for c in internal:
        new.add_channel(c)

    new_sel = Selection({n: v for n, v in sel.choices.items() if n != name})
    for p, ch in zip(parts, choices):
        new_sel.set(p.name, *ch)
    rg = RestructuredGraph(stg=new, selection=new_sel,
                           groups={name: tuple(p.name for p in parts)})
    validate_restructure(stg, rg, touched={name} | {p.name for p in parts})
    return rg


def validate_restructure(old: STG, rg: RestructuredGraph, *,
                         touched: set[str]) -> None:
    """Structural validation of a rewrite: the new graph is a legal
    feed-forward STG with consistent rates, the Selection covers exactly
    its nodes, and every channel not incident to a rewritten node is
    preserved verbatim."""
    rg.stg.validate()
    rg.stg.repetition_vector()          # raises on rate inconsistency
    have = set(rg.selection.choices)
    want = set(rg.stg.nodes)
    if have != want:
        raise ValueError(f"selection does not cover the rewritten graph: "
                         f"missing {want - have}, extra {have - want}")
    old_keys = {c.key() for c in old.channels
                if c.src not in touched and c.dst not in touched}
    new_keys = {c.key() for c in rg.stg.channels
                if c.src not in touched and c.dst not in touched}
    if old_keys != new_keys:
        raise ValueError(f"rewrite disturbed untouched channels: "
                         f"{old_keys ^ new_keys}")


# ===========================================================================
# planner-side fusion scoring (virtual clock + measured host cost)
# ===========================================================================
@dataclass(frozen=True)
class FusionScore:
    """One candidate partition of the stage chain, scored on the virtual
    clock.  ``period_us`` is the steady-state pipeline period: the host
    dispatches fused programs serially (sum of one dispatch per group)
    and the slowest group bounds the device side."""

    groups: tuple[tuple[str, ...], ...]
    period_us: float
    host_us: float          # total dispatch cost per token (serial)
    bottleneck_us: float    # slowest group: device + its one dispatch

    @property
    def fused(self) -> bool:
        return any(len(g) > 1 for g in self.groups)


def _stage_host(name, host_us) -> float:
    if name in host_us:
        return float(host_us[name])
    # measured on an already-fused run: a member of a fused stage costs
    # one dispatch on its own too, and a dispatch costs what a dispatch
    # costs — inherit the fused measurement, don't apportion it.
    for key, v in host_us.items():
        if name in key.split("+"):
            return float(v)
    return 1.0


def _group_host(group, host_us) -> float:
    key = "+".join(group)
    if key in host_us:          # measured on an already-fused run
        return float(host_us[key])
    return max(_stage_host(n, host_us) for n in group)


def score_fusion(groups, *, host_us=None, dev_us=None,
                 replicas=None) -> FusionScore:
    """Virtual-clock score of one partition.  ``host_us`` is the measured
    per-stage dispatch cost (``per_stage_host_us``) folded in as a fixed
    cost per firing — one dispatch per *group* after fusion.  Keys may be
    base stage names or ``+``-joined fused names (so re-scoring with
    measurements from a fused run reaches the same fixed point)."""
    host_us = host_us or {}
    dev_us = dev_us or {}
    replicas = replicas or {}
    groups = tuple(tuple(g) for g in groups)
    serial = sum(_group_host(g, host_us) for g in groups)
    bottleneck = 0.0
    for g in groups:
        nr = min(int(replicas.get(n, 1)) for n in g)
        dev = sum(float(dev_us.get(n, 0.0)) for n in g) / max(1, nr)
        bottleneck = max(bottleneck, dev + _group_host(g, host_us))
    return FusionScore(groups=groups, period_us=max(serial, bottleneck),
                       host_us=serial, bottleneck_us=bottleneck)


def enumerate_fusions(names, *, heavy=(), max_group: int | None = None):
    """All contiguous partitions of the stage chain with at most one
    ``heavy`` member per group.  Heavy stages own resident pipeline state
    (KV-cache period spans): fusing two of them is the planner's
    ``periods_per_stage`` axis, not stage combining, and would relocate
    live state — so those candidates are structurally excluded."""
    names = list(names)
    heavy = set(heavy)
    out = []

    def rec(i, acc):
        if i == len(names):
            out.append(tuple(acc))
            return
        for j in range(i + 1, len(names) + 1):
            g = tuple(names[i:j])
            if max_group is not None and len(g) > max_group:
                break
            if sum(1 for n in g if n in heavy) > 1:
                break
            rec(j, acc + [g])

    rec(0, [])
    return out


def auto_fusion(names, *, host_us=None, dev_us=None, heavy=(),
                replicas=None, slack: float = 1.0,
                max_group: int | None = None,
                dev_in_score: bool = True) -> FusionScore:
    """Pick the fusion plan that minimizes the virtual-clock period.

    Candidates are contiguous partitions of the chain (``enumerate_fusions``
    structural rules).  Two further guards: members of a group must share a
    replica count (``combine`` requires it), and a group's summed device
    time may not exceed ``(1 + slack)`` x the unfused per-stage bottleneck
    — combining below the bottleneck deletes dispatch for free; raising the
    device bottleneck is the *splitting* direction's trade, not fusion's.
    Ties prefer the partition with more groups (least fusion).

    ``dev_in_score=False`` keeps device time in the guards but out of the
    score — the no-measurement mode, where host cost is a uniform
    placeholder and the score reduces to minimizing dispatch count
    (mixing placeholder units into microsecond device times would let the
    device term veto every fusion).
    """
    names = list(names)
    host_us = host_us or {}
    dev_us = dev_us or {}
    replicas = replicas or {}
    max_dev = max((float(dev_us.get(n, 0.0)) / max(1, int(replicas.get(n, 1)))
                   for n in names), default=0.0)
    best = None
    for cand in enumerate_fusions(names, heavy=heavy, max_group=max_group):
        ok = True
        for g in cand:
            if len({int(replicas.get(n, 1)) for n in g}) != 1:
                ok = False
                break
            nr = int(replicas.get(g[0], 1))
            dev = sum(float(dev_us.get(n, 0.0)) for n in g) / max(1, nr)
            if max_dev > 0 and dev > (1.0 + slack) * max_dev:
                ok = False
                break
        if not ok:
            continue
        sc = score_fusion(cand, host_us=host_us,
                          dev_us=dev_us if dev_in_score else None,
                          replicas=replicas)
        key = (sc.period_us, sc.host_us, -len(sc.groups))
        if best is None or key < best[0]:
            best = (key, sc)
    if best is None:
        raise ValueError("no feasible fusion candidate (replica counts "
                         "unalignable?)")
    return best[1]
