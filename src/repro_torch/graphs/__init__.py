"""Task graphs the planner runs on: the LM graph (`lm_graph`)."""
from . import lm_graph  # noqa: F401
