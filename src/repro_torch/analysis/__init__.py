"""The card's published rates, a step's roofline and counts, and the
bytes a decode stage moves."""
from .roofline import (HW_H100, Hardware, RooflineReport, analyze_step,  # noqa: F401
                       decode_stage_bytes, fraction_of_roofline)
from .step_cost import Cost, count_step  # noqa: F401
