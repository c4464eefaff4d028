"""The card's published rates, a step's roofline, counts and collectives,
and the bytes a decode stage moves."""
from .collectives import count_collectives  # noqa: F401
from .roofline import (HW_H100, CollectiveStats, Hardware, RooflineReport,  # noqa: F401
                       analyze_step, decode_stage_bytes, fraction_of_roofline,
                       measure_host_bandwidth)
from .step_cost import Cost, count_step  # noqa: F401
