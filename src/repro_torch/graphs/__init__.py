"""Task graphs the planner runs on: the LM graph (`lm_graph`) and the
paper's own benchmarks (`jpeg`, `nbody`, `streamit`)."""
from . import jpeg, lm_graph, nbody, streamit  # noqa: F401
