"""Core of the paper's contribution: automated space/time scaling of STGs.

Copies of ``repro/core``'s graph, intra-node optimizer, throughput
analysis, solvers, router model, replication transforms, KPN simulator,
restructuring, planner and static verifier, with the names and behaviour
unchanged.
"""
from . import (fork_join, heuristic, ilp, intra_node, planner,  # noqa: F401
               restructure, simulate, throughput, transform)
from .fork_join import JPEG_CALIBRATED, LITERAL, ForkJoinModel  # noqa: F401
from .restructure import (FusionScore, RestructuredGraph, auto_fusion,  # noqa: F401
                          combine, enumerate_fusions, score_fusion, split,
                          validate_restructure)
from .stg import STG, Channel, Impl, Node, Selection  # noqa: F401
from .verify import (ERROR, WARN, EdgeSpec, Finding,  # noqa: F401
                     PlanVerificationError, VerificationReport,
                     verify_decode_plan, verify_graph)
