"""K3's frozen measurement arithmetic: the bytes and operations of one
launch of ``hk_step_kernel`` and its bound.

Copied from ``chip_smoke.py`` (``hanabi_legal_ops``, ``hanabi_ops``,
``hanabi_work`` for one step) and kept here, so that a later change to that
script or to the program cannot move the yardstick.  Every count comes from
the game's constants and the batch; nothing here reads a clock or imports
the program.

**Resets.** A launch is counted with no world resetting: every world reads
its stale seat's obs, own-hand and mask bytes (P - 1 seats) and does no
deal.  A reset instead skips that seat's read (803 bytes in the full game)
and adds a deal and a seat's encode (340 operations); at the cell's batch
the bound is set by the bytes, so the rule counts the most bytes a launch
can need and the bound reads at most a reset's share high.
"""

from __future__ import annotations

from typing import Tuple

from port_bench import yardstick

# the state's 16 scalar rows (the deck size, the tokens, the turn, the
# score, the last move's nine fields and the episode's LCG word)
SCALAR_ROWS = 16


def game_sizes(colors: int, ranks: int, players: int, **_ignored):
    """(C, R, P, H, A, M): the game's colours, ranks, players, hand size,
    moves and deck size."""
    C, R, P = colors, ranks, players
    H = 5 if P < 4 else 4
    M = C * (3 + 2 * (R - 2) + 1)
    return C, R, P, H, 2 * H + (P - 1) * (C + R), M


def state_rows(game: dict) -> int:
    """The int32 rows of one world's state: the deck, the discards, the
    fireworks, the scalars, then per seat and slot the hand cards, the
    plausible masks, the known colours and ranks, and per seat the hand
    size (``ops/hanabi.py``'s layout, 138 in the full game)."""
    C, R, P, H, _, M = game_sizes(**game)
    return M + C * R + C + SCALAR_ROWS + 4 * P * H + P


def obs_size(game: dict) -> int:
    C, R, P, H, _, M = game_sizes(**game)
    return ((P - 1) * H * C * R + P + (M - P * H) + C * R + game["max_information_tokens"]
            + game["max_life_tokens"] + M + P + 4 + P + C + R + 2 * H + C * R + 2
            + P * H * (C * R + C + R))


def legal_ops(game: dict) -> int:
    """One seat's legal set and its size: the discard and play bits (4),
    a colour, a rank and two bit sets per card of each partner (4 H each),
    the presence masks joined and counted (3)."""
    _, _, P, H, _, _ = game_sizes(**game)
    return (P - 1) * 4 * H + 7


def step_ops(game: dict) -> Tuple[int, int, int]:
    """(step, seat, reset): the operations of the move, of one refreshed
    seat's encode and of a deal, one per value each must test or produce
    (``chip_smoke.py``'s ``hanabi_ops``)."""
    C, R, P, H, _, _ = game_sizes(**game)
    step = 48 + 3 * H + C
    seat = 27 + C + C * R + 6 * P * H + legal_ops(game)
    reset = 136 + 6 * P * H
    return step, seat, reset


def k3_work(game: dict, num_envs: int) -> Tuple[int, int]:
    """Bytes and operations of one K3 launch over ``num_envs`` worlds, none
    resetting: the state (4 B a row) read and written, the stale seats'
    obs, own and mask bytes read, every seat's written, the acting seat's
    action (4 B) read, reward (4 B) and done (1 B) written, the episode
    counter (8 B) read and written; a step and one refreshed seat a
    world."""
    C, R, P, H, A, _ = game_sizes(**game)
    seat_bytes = obs_size(game) + H * C * R + A
    step, seat, _ = step_ops(game)
    nbytes = (num_envs * (8 * state_rows(game) + P * seat_bytes + 4 + 5)
              + num_envs * (P - 1) * seat_bytes + 16)
    return nbytes, num_envs * (step + seat)


def k3_bound_ms(game: dict, num_envs: int) -> float:
    """The least time of one K3 launch, ms: ``yardstick.bound`` at 3.35 TB/s
    and 33.45 T instructions/s."""
    return yardstick.bound(*k3_work(game, num_envs))[0]

