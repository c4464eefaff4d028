"""Fork/join replication trees and node combining (paper §II.B.2.c, Eq. 8-14).

Replicating a bottleneck node D ``nr = v_D / v_S`` times (Eq. 8) requires
round-robin fork (and, symmetrically, join) trees when ``nr`` exceeds the
fabric fan-out ``nf``.  The paper's literal overhead for one tree reaching
``nr = nf^H`` leaves (Eq. 9):

    A_O = sum_{i=0}^{H-1} nf^i ,   H = ceil(log_nf nr)

Node *combining* (Fig. 8, Eq. 10-14) replaces a layer of pass-through fork
nodes with a slower re-implementation S' of the producer fused with ``nf``
copies of D, cutting the overhead to Eq. 14 and saving ``nf^(H-1)`` nodes
(>75% for nf = 4).

``ForkJoinModel`` parameterises the cost model.  Two presets:

  * LITERAL          — Eq. 9 verbatim (nf = 4, unit-area pass-through nodes).
  * JPEG_CALIBRATED  — nf = 4 with pass-through PEs costing 16 area units,
    which reproduces the published Table-2 ILP overhead column for the
    extreme rows (nr=512 -> 10912 vs published 10880; nr=128 -> 2720 vs
    2688).  The paper's own Eq. 9 cannot produce its Table-2 overheads
    (341 vs 10880 for nr=512); see EXPERIMENTS.md §Reproduction notes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


def tree_height(nr: int, nf: int) -> int:
    """H = ceil(log_nf nr) (paper, below Eq. 8)."""
    if nr <= 1:
        return 0
    return math.ceil(math.log(nr) / math.log(nf) - 1e-12)


def tree_overhead_eq9(nr: int, nf: int) -> int:
    """Literal Eq. 9: number of routing nodes in one tree to nr leaves."""
    H = tree_height(nr, nf)
    return sum(nf ** i for i in range(H))


def combined_tree_overhead_eq14(nr: int, nf: int) -> int:
    """Eq. 14: overhead after one combining step (tree of nr' = nr/nf)."""
    H = tree_height(nr, nf)
    return sum(nf ** i for i in range(max(0, H - 1)))


def combining_savings(nr: int, nf: int) -> int:
    """Nodes saved by one combining step: Eq. 9 minus Eq. 14 = nf^(H-1)."""
    H = tree_height(nr, nf)
    if H == 0:
        return 0
    return nf ** (H - 1)


def layer_rates(v_s: float, v_d: float, nf: int, h: int, H: int) -> tuple[float, float]:
    """Eq. 10-11: inverse throughputs seen at fork-tree layer h (1-indexed).

    v_in^h  = v_S * nf^(h-1) = v_D / nf^(H+1-h)    (paper Eq. 10)
    v_out^h = v_in^h * nf                          (paper Eq. 11)
    """
    v_in = v_s * nf ** (h - 1)
    return v_in, v_in * nf


def replicas_needed(v_d: float, v_s: float) -> int:
    """Eq. 8: nr = v_D / v_S, rounded up to an integer."""
    return max(1, math.ceil(v_d / v_s - 1e-12))


@dataclass(frozen=True)
class ForkJoinModel:
    """Cost model for round-robin distribution/collection trees.

    nf:         fabric fan-out/fan-in per node.
    node_area:  area of one pass-through routing PE.
    count_root: Eq. 9 counts the layer adjacent to the source (True matches
                the published equation); False grants the paper's stated
                free fan-out of nf from the source node itself.
    """

    nf: int = 4
    node_area: float = 1.0
    count_root: bool = True

    def tree_nodes(self, fan: int) -> int:
        """Routing nodes for one source reaching ``fan`` destinations."""
        if fan <= 1:
            return 0
        if not self.count_root and fan <= self.nf:
            return 0
        n = tree_overhead_eq9(fan, self.nf)
        if not self.count_root:
            n = max(0, n - 1)
        return n

    def overhead(self, nr_src: int, nr_dst: int) -> float:
        """Area overhead to connect nr_src producer replicas to nr_dst
        consumer replicas round-robin.  The side with fewer replicas grows a
        tree per replica toward the other side; equal counts pair up freely."""
        lo, hi = sorted((max(1, nr_src), max(1, nr_dst)))
        if hi == lo:
            return 0.0
        fan = math.ceil(hi / lo)
        return lo * self.tree_nodes(fan) * self.node_area

    def channel_overhead(self, nr_src: int, nr_dst: int) -> float:
        return self.overhead(nr_src, nr_dst)

    def replication_overhead(self, nr: int, fork: bool = True, join: bool = True) -> float:
        """Overhead of replicating an isolated node nr times from/to
        unreplicated neighbours (one fork tree + one join tree)."""
        total = 0.0
        if fork:
            total += self.overhead(1, nr)
        if join:
            total += self.overhead(nr, 1)
        return total


LITERAL = ForkJoinModel(nf=4, node_area=1.0, count_root=True)
# Calibrated so ILP-mode replication overhead matches the published Table 2
# (fork+join trees of non-free pass-through PEs; see module docstring).
JPEG_CALIBRATED = ForkJoinModel(nf=4, node_area=16.0, count_root=True)
