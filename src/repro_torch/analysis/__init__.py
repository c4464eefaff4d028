"""The card's published rates and the bytes a decode stage moves."""
from .roofline import HW_H100, Hardware, decode_stage_bytes, fraction_of_roofline  # noqa: F401
