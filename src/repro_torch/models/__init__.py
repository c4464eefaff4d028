"""Dense decoder model of the port: blocks and LM assembly."""
from .lm import build_model  # noqa: F401
