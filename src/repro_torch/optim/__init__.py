"""Optimizers and learning-rate schedules of the port (``repro/optim``)."""
from .adafactor import adafactor  # noqa: F401
from .adamw import adamw  # noqa: F401
from .api import Optimizer, get_optimizer  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401
