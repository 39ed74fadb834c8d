"""The port's batch simulators."""

from . import acrobot, balance_beam, cartpole, hanabi, overcooked, overcooked2
from .layouts import LAYOUTS, get_base_layout_params

__all__ = ["acrobot", "balance_beam", "cartpole", "hanabi", "overcooked", "overcooked2",
           "LAYOUTS", "get_base_layout_params"]
