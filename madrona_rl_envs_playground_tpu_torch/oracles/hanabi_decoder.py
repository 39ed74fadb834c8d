"""Hanabi observation decoder + full semantic validator.

The port's own copy of ``madrona_rl_envs_playground_tpu/oracles/hanabi_decoder.py``,
its counterpart: the code is that file's, line for line
(``tests/test_torch_oracles.py`` compares the two).

Analog of the reference's ``HanabiState`` machinery, all four layers:

* **decode + representation invariants** (``envs/hanabi_env.py:157-298``):
  parse the exported bit-vector STATE tensor back into structured fields and
  validate one-hot hand encodings, monotone thermometers, token ranges, and
  whole-game **card-count conservation**.
* **abstract step simulation** (``:300-370``): apply the move to the decoded
  state using nothing but the game rules and predict done / reward.
* **action-mask validation** (``:372-435``): re-derive the legal-move mask
  from the decoded state and compare bit-for-bit (one-sided for reveal bits
  when the partner hand has dead slots — the simulator reproduces the
  reference C++'s stale-dead-slot reveal quirk, and dead slots' stale cards
  are by design invisible in the encoding).
* **cross-step equivalence** (``:437-475``): the decoded next state must
  match the abstractly-stepped old state, with hands compared as multisets
  up to the one replacement draw (strictly stronger than the reference's
  per-card membership test).

``validate_step`` orchestrates all of it over live batched rollouts —
active-seat uniqueness, turn alternation, obs==state-prefix, and the
post-done fresh-episode structure checks (``:478-657``) — so any rule
violation that a bit-diff against a co-derived oracle cannot see (wrong
token refund, mis-scored play, phantom card) is caught from the exported
tensors alone.  ``tests/test_hanabi_validator.py`` runs it over the jnp and
megakernel paths and proves the catch with corrupted-transition mutations.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class DecodedState:
    partner_hands: List[List[int]]   # [P-1][<=H] card ids, observer-relative
    own_hand: List[int]              # [<=H] card ids (STATE tensor only)
    hands_missing_card: List[bool]   # [P]
    deck_size: int
    fireworks: List[int]             # [C]
    info_tokens: int
    life_tokens: int
    discards: List[int]              # [C*R] counts
    know_live: List[List[bool]]      # [P][H]


def _thermo(bits: np.ndarray) -> int:
    """Monotone 1..10... run length; raises if not a thermometer."""
    n = int(bits.sum())
    if not np.all(bits[:n] == 1) or not np.all(bits[n:] == 0):
        raise AssertionError(f"not a thermometer encoding: {bits}")
    return n


def decode_state(env, state_vec: np.ndarray) -> DecodedState:
    """env: envs.hanabi.Env; state_vec: [state_size] int8 for one seat."""
    C, R, P, H = env.colors, env.ranks, env.players, env.hand
    BPC = env.bits_per_card
    v = np.asarray(state_vec)
    assert v.shape == (env.state_size,), v.shape
    assert np.all((v == 0) | (v == 1)), "state bits must be 0/1"
    off = 0

    partner_hands = []
    for _ in range(P - 1):
        hand = []
        for slot in range(H):
            oh = v[off:off + BPC]
            off += BPC
            s = int(oh.sum())
            assert s in (0, 1), f"hand slot not one-hot: sum={s}"
            if s == 1:
                hand.append(int(np.argmax(oh)))
        partner_hands.append(hand)
    hands_missing = [bool(v[off + i]) for i in range(P)]
    off += P

    deck_size = _thermo(v[off:off + env.max_deck_bits])
    off += env.max_deck_bits

    fireworks = []
    for _ in range(C):
        oh = v[off:off + R]
        off += R
        s = int(oh.sum())
        assert s in (0, 1), "fireworks not one-hot"
        fireworks.append(0 if s == 0 else int(np.argmax(oh)) + 1)

    info_tokens = _thermo(v[off:off + env.max_info])
    off += env.max_info
    life_tokens = _thermo(v[off:off + env.max_life])
    off += env.max_life

    discards = [0] * (C * R)
    for bit in range(env.sz_discard):
        if v[off + bit]:
            discards[int(env._discard_ids[bit])] += 1
    # thermometer-per-card-id check
    for bit in range(env.sz_discard):
        cid, thr = int(env._discard_ids[bit]), int(env._discard_thr[bit])
        assert bool(v[off + bit]) == (discards[cid] > thr), "discard thermometer"
    off += env.sz_discard

    off += env.sz_last  # last-action section: format-checked implicitly below

    know_live = []
    per = BPC + C + R
    for p in range(P):
        row = []
        for slot in range(H):
            blk = v[off:off + per]
            off += per
            row.append(bool(blk[:BPC].any() or blk[BPC:].any()))
        know_live.append(row)

    own_hand = []
    for slot in range(H):
        oh = v[off:off + BPC]
        off += BPC
        s = int(oh.sum())
        assert s in (0, 1), "own-hand slot not one-hot"
        if s == 1:
            own_hand.append(int(np.argmax(oh)))
    assert off == env.state_size, (off, env.state_size)

    return DecodedState(
        partner_hands=partner_hands,
        own_hand=own_hand,
        hands_missing_card=hands_missing,
        deck_size=deck_size,
        fireworks=fireworks,
        info_tokens=info_tokens,
        life_tokens=life_tokens,
        discards=discards,
        know_live=know_live,
    )


def validate_invariants(env, dec: DecodedState) -> None:
    """Cross-field invariants, incl. card conservation
    (reference ``envs/hanabi_env.py:238-298``)."""
    C, R, P, H = env.colors, env.ranks, env.players, env.hand

    assert 0 <= dec.info_tokens <= env.max_info
    assert 1 <= dec.life_tokens <= env.max_life
    assert 0 <= dec.deck_size <= env.max_deck_bits

    counts = [0] * (C * R)
    for hand in dec.partner_hands + [dec.own_hand]:
        assert len(hand) <= H
        for card in hand:
            counts[card] += 1
    for cid, n in enumerate(dec.discards):
        counts[cid] += n
    for c, fw in enumerate(dec.fireworks):
        for r in range(fw):
            counts[c * R + r] += 1

    total_placed = sum(counts)
    assert total_placed + dec.deck_size == env.max_cards, (
        f"card conservation: placed {total_placed} + deck {dec.deck_size} "
        f"!= {env.max_cards}"
    )
    for cid, n in enumerate(counts):
        limit = env.cr_num[cid % R]
        assert n <= limit, f"card {cid} appears {n} > multiplicity {limit}"


# ---------------------------------------------------------------------------
# abstract game state + rule-level step simulation
# (reference envs/hanabi_env.py:300-475, re-derived from the rules)
# ---------------------------------------------------------------------------

_WILD = -1  # a played/discarded slot whose replacement draw is unknown


@dataclasses.dataclass
class AbstractState:
    """Rules-level game state assembled from one seat's decoded STATE
    tensor — hands indexed by ABSOLUTE player id (2-player configs, like
    the reference validator)."""

    hands: List[List[int]]    # [P][<=H] card ids (live slots only)
    hand_sizes: List[int]     # [P]
    cur: int
    deck_size: int
    fireworks: List[int]
    info_tokens: int
    life_tokens: int
    discards: List[int]


def abstract_from_decoded(env, dec: DecodedState, curagent: int) -> AbstractState:
    """Decoded(seat=curagent) -> absolute-player abstract state.  The STATE
    tensor carries the observer's own hand in its suffix and the partner's
    in the obs prefix (observer-relative), so for P=2 the mapping is just a
    seat swap."""
    assert env.players == 2, "the semantic validator covers 2-player configs"
    hands = [None, None]
    hands[curagent] = list(dec.own_hand)
    hands[1 - curagent] = list(dec.partner_hands[0])
    return AbstractState(
        hands=hands,
        hand_sizes=[len(hands[0]), len(hands[1])],
        cur=curagent,
        deck_size=dec.deck_size,
        fireworks=list(dec.fireworks),
        info_tokens=dec.info_tokens,
        life_tokens=dec.life_tokens,
        discards=list(dec.discards),
    )


def simulate_step(env, ab: AbstractState, action: int):
    """Apply ``action`` to the abstract state using only the game rules
    (reference ``simulate_step``, envs/hanabi_env.py:300-370).  Mutates
    ``ab`` in place; returns ``(maybe_done, deck_was_empty, reward)``.
    ``maybe_done`` is the done the rules FORCE (death / all fireworks);
    turn-exhaustion done cannot be derived from the tensors (the turn
    counter is not observed), so callers accept an observed done when the
    deck was already empty, exactly as the reference does (:543-548).

    The played/discarded slot becomes a wild card: its replacement draw is
    hidden information, resolved by the multiset rules in
    ``assert_equivalent``.  Info tokens can transiently exceed the encoding
    cap (a play completing a firework at full tokens); the thermometer
    clamps, so comparisons cap at ``max_info`` (the C++ state is likewise
    uncapped while its encoder clamps)."""
    H, R = env.hand, env.ranks
    cur = ab.cur
    deck_was_empty = ab.deck_size == 0
    reward = 0

    def consume_slot(idx):
        ab.hands[cur][idx] = _WILD
        if ab.deck_size > 0:
            ab.deck_size -= 1
        else:
            ab.hand_sizes[cur] -= 1
            # the shifted-out slot disappears from the live hand
            ab.hands[cur].pop(idx)

    if action < H:  # discard
        card = ab.hands[cur][action]
        ab.discards[card] += 1
        ab.info_tokens += 1
        consume_slot(action)
    elif action < 2 * H:  # play
        idx = action - H
        card = ab.hands[cur][idx]
        col, rank = card // R, card % R
        if ab.fireworks[col] == rank:
            ab.fireworks[col] += 1
            if ab.fireworks[col] == R:
                ab.info_tokens += 1
            reward += 1
        else:
            ab.discards[card] += 1
            ab.life_tokens -= 1
        consume_slot(idx)
    else:  # reveal color / reveal rank
        ab.info_tokens -= 1

    ab.cur = 1 - cur
    done = False
    if ab.life_tokens < 1:
        done = True
        reward -= sum(ab.fireworks)  # score zeroes on death (delta-score)
    if sum(ab.fireworks) == env.colors * env.ranks:
        done = True
    return done, deck_was_empty, reward


def validate_action_mask(env, ab: AbstractState, mask: np.ndarray) -> None:
    """Re-derive the legal-move mask from the abstract state and compare
    (reference ``validate_action_masks``, envs/hanabi_env.py:372-435).

    Discard/play bits are exact.  Reveal bits are exact while the partner
    hand is full; once it has dead slots the simulator's reveal legality
    still scans the stale cards parked there (a reproduced reference-C++
    quirk, ``src/hanabi_env/sim.cpp:414-436``) which the encoding cannot
    show, so absent-from-live-hand colors/ranks are checked one-sided:
    a reveal the live hand justifies must be legal, and with zero info
    tokens every reveal must be illegal."""
    C, R, H = env.colors, env.ranks, env.hand
    cur = ab.cur
    mask = np.asarray(mask).astype(bool)
    off = 0
    for i in range(H):
        want = (i < ab.hand_sizes[cur]) and (ab.info_tokens < env.max_info)
        assert mask[off] == want, f"discard mask bit {i}: {mask[off]} != {want}"
        off += 1
    for i in range(H):
        want = i < ab.hand_sizes[cur]
        assert mask[off] == want, f"play mask bit {i}: {mask[off]} != {want}"
        off += 1
    partner = ab.hands[1 - cur]
    partner_full = ab.hand_sizes[1 - cur] == H
    info_ok = ab.info_tokens > 0
    for c in range(C):
        has = any(card // R == c for card in partner if card != _WILD)
        bit = mask[off]
        if partner_full:
            assert bit == (info_ok and has), f"reveal-color mask bit {c}"
        else:
            if not info_ok:
                assert not bit, f"reveal-color {c} legal with 0 info tokens"
            elif has:
                assert bit, f"reveal-color {c} illegal despite live match"
        off += 1
    for r in range(R):
        has = any(card % R == r for card in partner if card != _WILD)
        bit = mask[off]
        if partner_full:
            assert bit == (info_ok and has), f"reveal-rank mask bit {r}"
        else:
            if not info_ok:
                assert not bit, f"reveal-rank {r} legal with 0 info tokens"
            elif has:
                assert bit, f"reveal-rank {r} illegal despite live match"
        off += 1


def assert_equivalent(env, ab: AbstractState, new: AbstractState) -> None:
    """The abstractly-stepped old state must match the decoded next state
    (reference ``equivalent``, envs/hanabi_env.py:437-475) — with hands
    compared as MULTISETS up to the one hidden replacement draw, which is
    strictly stronger than the reference's per-card membership test."""
    import collections

    assert ab.hand_sizes == new.hand_sizes, (
        f"hand sizes {ab.hand_sizes} != {new.hand_sizes}")
    for p in range(env.players):
        old_live = collections.Counter(
            c for c in ab.hands[p] if c != _WILD)
        new_live = collections.Counter(new.hands[p])
        missing = old_live - new_live
        assert not missing, (
            f"player {p}: cards {dict(missing)} vanished from the hand")
        extra = new_live - old_live
        n_extra = sum(extra.values())
        had_wild = _WILD in ab.hands[p]
        assert n_extra <= (1 if had_wild else 0), (
            f"player {p}: {dict(extra)} appeared without a draw")
    assert ab.deck_size == new.deck_size, (
        f"deck {ab.deck_size} != {new.deck_size}")
    assert ab.fireworks == new.fireworks, (
        f"fireworks {ab.fireworks} != {new.fireworks}")
    assert min(ab.info_tokens, env.max_info) == new.info_tokens, (
        f"info tokens {ab.info_tokens} != {new.info_tokens}")
    assert ab.life_tokens == new.life_tokens, (
        f"life tokens {ab.life_tokens} != {new.life_tokens}")
    assert ab.discards == new.discards, (
        f"discards {ab.discards} != {new.discards}")


def check_initial_structure(env, obs_vec: np.ndarray,
                            state_vec: np.ndarray) -> None:
    """Post-done states must be a fresh episode (reference
    envs/hanabi_env.py:577-650): full one-hot hands, full deck thermometer,
    zero fireworks/discards, all tokens, no last action."""
    C, R, P, H = env.colors, env.ranks, env.players, env.hand
    BPC = env.bits_per_card
    v = np.asarray(obs_vec)
    off = 0
    for _ in range((P - 1) * H):
        assert v[off:off + BPC].sum() == 1, "fresh hand slot not one-hot"
        off += BPC
    assert not v[off:off + P].any(), "fresh hands must read full"
    off += P
    assert v[off:off + env.max_deck_bits].all(), "fresh deck not full"
    off += env.max_deck_bits
    assert not v[off:off + C * R].any(), "fresh fireworks not empty"
    off += C * R
    assert v[off:off + env.max_info + env.max_life].all(), (
        "fresh tokens not full")
    off += env.max_info + env.max_life
    assert not v[off:off + env.sz_discard].any(), "fresh discards not empty"
    off += env.sz_discard
    assert not v[off:off + env.sz_last].any(), "fresh last-action not empty"
    sv = np.asarray(state_vec)
    off = env.obs_size
    for _ in range(H):
        assert sv[off:off + BPC].sum() == 1, "fresh own-hand slot not one-hot"
        off += BPC


def validate_step(env, prev_out, actions, next_out, done) -> None:
    """Full per-step semantic validation of a live batched transition
    (reference ``validate_step``, envs/hanabi_env.py:478-657).

    ``prev_out``/``next_out``: StepOutput-like objects with numpy-able
    ``obs [N, P, OBS]``, ``state_obs [N, P, STATE]``, ``action_mask
    [N, P, A]``, ``active [N, P]``; ``actions [N, P]`` the ids fed to the
    step; ``done [N]`` and ``next_out.reward [N, P]`` the step's results.
    Raises AssertionError with env index context on the first violation.
    """
    active_p = np.asarray(prev_out.active)
    active_n = np.asarray(next_out.active)
    state_p = np.asarray(prev_out.state_obs)
    state_n = np.asarray(next_out.state_obs)
    obs_n = np.asarray(next_out.obs)
    mask_p = np.asarray(prev_out.action_mask)
    mask_n = np.asarray(next_out.action_mask)
    rewards = np.asarray(next_out.reward)
    actions = np.asarray(actions)
    done = np.asarray(done)
    n = done.shape[0]

    for i in range(n):
        try:
            assert active_p[i].sum() == 1, "exactly one active seat"
            assert active_n[i].sum() == 1, "exactly one active seat after"
            cur = int(np.argmax(active_p[i]))
            newcur = int(np.argmax(active_n[i]))
            if not done[i]:
                assert newcur == 1 - cur, "active seat must switch"
            # state prefix == obs for the refreshed seat
            np.testing.assert_array_equal(
                state_n[i, newcur, :env.obs_size], obs_n[i, newcur],
                err_msg="state prefix != obs")

            old = decode_state(env, state_p[i, cur])
            validate_invariants(env, old)
            ab = abstract_from_decoded(env, old, cur)
            validate_action_mask(env, ab, mask_p[i, cur])

            maybe_done, deck_was_empty, rew = simulate_step(
                env, ab, int(actions[i, cur]))
            if maybe_done:
                assert done[i], "rules force done but step reports not-done"
            if done[i]:
                assert maybe_done or deck_was_empty, (
                    "done without death/completion/deck exhaustion")
            for p in range(env.players):
                assert rew == int(rewards[i, p]), (
                    f"reward seat {p}: rules say {rew}, got {rewards[i, p]}")

            new = decode_state(env, state_n[i, newcur])
            validate_invariants(env, new)
            ab_new = abstract_from_decoded(env, new, newcur)
            validate_action_mask(env, ab_new, mask_n[i, newcur])

            if done[i]:
                check_initial_structure(
                    env, obs_n[i, newcur], state_n[i, newcur])
            else:
                assert_equivalent(env, ab, ab_new)
        except AssertionError as e:
            raise AssertionError(f"env {i}: {e}") from e
