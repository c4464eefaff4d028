"""N-body gravity force node (paper §II.A.3, Figs. 2-4, Eq. 2).

The 2D force calculation's primitive DAG.  Per the paper: division takes 8
cycles and stalls the naive pipeline at II=8 (Fig. 2); expansion reaches
II=1 (Fig. 3); the implementation frontier spans II = 1 .. 33 where 33 is
the whole node folded onto one PE (Fig. 4) — i.e. op iis sum to 33.

F_ij = G * Mi * Mj / |Pi - Pj|^3 * (Pi - Pj),  G = 0.0625

Copied from ``repro/graphs/nbody.py``: plain Python and numpy, the names and
behaviour unchanged.
"""
from __future__ import annotations

import numpy as np

from ..core.intra_node import CompositeBody, PrimOp, enumerate_impls
from ..core.stg import SINK, SOURCE, STG, Impl, Node

G_CONST = 0.0625

# Primitive DAG for the 2D force kernel.  Latencies follow the paper's PE
# model (add/sub 1, mul 2, div/sqrt 8); total = 33 so the single-PE
# implementation has II = 33 exactly as Fig. 4's slowest point.
FORCE_OPS = (
    PrimOp("dx", "sub"),                              # Pi.x - Pj.x      (1)
    PrimOp("dy", "sub"),                              # Pi.y - Pj.y      (1)
    PrimOp("dx2", "mul", ("dx",)),                    # dx*dx            (2)
    PrimOp("dy2", "mul", ("dy",)),                    # dy*dy            (2)
    PrimOp("r2", "add", ("dx2", "dy2")),              # dx2+dy2          (1)
    PrimOp("r", "sqrt", ("r2",)),                     # sqrt             (8)
    PrimOp("r3", "mul", ("r2", "r")),                 # r2*r             (2)
    PrimOp("mm", "mul", ()),                          # Mi*Mj            (2)
    PrimOp("gmm", "mul", ("mm",)),                    # G*Mi*Mj          (2)
    PrimOp("f", "div", ("gmm", "r3")),                # gmm / r3         (8)
    PrimOp("fx", "mul", ("f", "dx")),                 # f*dx             (2)
    PrimOp("fy", "mul", ("f", "dy")),                 # f*dy             (2)
)

FORCE_BODY = CompositeBody(ops=FORCE_OPS)


def force_impls() -> list[Impl]:
    """The Fig. 4 frontier: II from 1 to 33."""
    return enumerate_impls(FORCE_BODY)


def force_fn(pair: tuple) -> tuple:
    """pair = (Pi(2,), Mi, Pj(2,), Mj) -> force vector (2,)."""
    pi, mi, pj, mj = pair
    d = np.asarray(pi, dtype=np.float64) - np.asarray(pj, dtype=np.float64)
    r2 = float(d @ d)
    r3 = r2 * np.sqrt(r2)
    f = G_CONST * mi * mj / r3
    return (f * d[0], f * d[1])


def build_stg() -> STG:
    """pairs -> force -> accumulate sink (streaming all-pairs)."""
    g = STG()
    g.add_node(Node("pairs", impls=(Impl("stream", area=0, ii=1e-9),), kind=SOURCE))
    def fn(inputs, state):
        return [[force_fn(inputs[0][0])]], state
    g.add_node(Node("force", impls=tuple(force_impls()), fn=fn))
    g.add_node(Node("acc", impls=(Impl("sink", area=0, ii=1e-9),), kind=SINK))
    g.connect("pairs", "force")
    g.connect("force", "acc")
    g.validate()
    return g


def random_pairs(n: int, seed: int = 0) -> list[tuple]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pi, pj = rng.normal(size=2), rng.normal(size=2)
        while np.allclose(pi, pj):
            pj = rng.normal(size=2)
        out.append((tuple(pi), float(rng.uniform(0.5, 2)), tuple(pj),
                    float(rng.uniform(0.5, 2))))
    return out
