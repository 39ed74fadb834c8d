"""The port's batch simulators (Overcooked so far)."""

from . import overcooked, overcooked2
from .layouts import LAYOUTS, get_base_layout_params

__all__ = ["overcooked", "overcooked2", "LAYOUTS", "get_base_layout_params"]
