"""Modern multiplayer Overcooked (reference ``src/overcooked_env/``)."""

from __future__ import annotations

from .layouts import get_base_layout_params
from .overcooked_base import NUM_ACTIONS, OvercookedEnv, State  # noqa: F401


def make(layout_name: str, horizon: int = 400, num_players=None) -> OvercookedEnv:
    params = get_base_layout_params(
        layout_name, horizon, max_num_players=num_players, variant="v1"
    )
    return OvercookedEnv(variant="v1", **params)
