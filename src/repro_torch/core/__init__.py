"""Core of the paper's contribution: automated space/time scaling of STGs.

Copies of ``repro/core``'s graph, throughput analysis, solvers, router
model, restructuring and planner, with the names and behaviour unchanged.
"""
from . import fork_join, heuristic, ilp, planner, restructure, throughput  # noqa: F401
from .fork_join import LITERAL, ForkJoinModel  # noqa: F401
from .restructure import (FusionScore, RestructuredGraph, auto_fusion,  # noqa: F401
                          combine, enumerate_fusions, score_fusion, split,
                          validate_restructure)
from .stg import STG, Channel, Impl, Node, Selection  # noqa: F401
