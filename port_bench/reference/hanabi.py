"""Plain Hanabi env: the benchmark's reference for K3 (``hk_step_kernel``).

The card game of the reference repository's ``src/hanabi_env/sim.cpp``,
written out from its rules with plain tensor operations over a batch of N
worlds.  It imports nothing of the program.  A world is one game of P
players; the state's fields carry the names and meanings that the
program's ``envs/hanabi.py`` documents for its ``State``, so that a state
is compared field by field.

Rules, as the reference simulator has them:

* **Deck**: 50 slots in the full game (per colour three 1s, two each of
  2-4, one 5), unshuffled in colour-major order; a card id is
  ``colour * R + rank``.  Every draw is a random swap: ``loc = int32(
  float32(size) * u)`` with ``u`` the next uniform of the world's LCG, the
  card at ``loc`` is taken, the deck's last card moves into ``loc`` (its
  old slot keeps its stale value) and the size drops by one.  The deal is
  P * H such draws, seat-major.
* **Randomness**: one stream an episode: an 8-round TEA of the episode
  index gives the first word of a 32-bit LCG (A = 1664525, C = 1013904223)
  whose low 24 bits make a float32 in [0, 1).  Episode indices are handed
  out in world order: world w of a step takes ``counter + (the worlds
  before it that are done)``, and the counter then adds the done worlds.
* **Moves** of the seat to act (``cur_player``), 2H + (P-1)(C+R) ids:
  discard slot h (``h``), play slot h (``H + h``), reveal colour c to the
  partner at offset o (``2H + (o-1)C + c``), reveal rank r (``2H + (P-1)C
  + (o-1)R + r``).  A discard gains an information token; a play that
  matches its colour's firework raises it, and completing a colour gains a
  token (no cap); a failed play is discarded and costs a life; a reveal
  costs a token and narrows the target's ``card_plausible`` masks (matched
  live slots keep the colour's or rank's bits, the others lose them) and
  records the matched colour or rank.  A played or discarded slot is
  refilled by a draw; from an empty deck the slots after it move down one
  and the hand shrinks (the last slot keeps its stale values).  Every
  move ends the turn.
* **Score, reward and end**: the score is the fireworks' sum while a life
  is left, else 0; the reward of a step is the change in score, the same
  for every seat.  Once the deck is empty each step takes one of the P
  final turns.  A game ends when the lives are gone, every firework is
  complete or the final turns are used up, and starts again within the
  step (the auto-reset) from the next episode index.
* **Observation** of a seat, five sections of bits: the partners' hands
  (each live slot a one-hot card id; then P flags "hand not full" in seat
  order from the observer), the board (deck size, fireworks, information
  and life tokens as thermometers or one-hots), the discards (one bit a
  copy of each card), the last move (its actor, kind, target, colour,
  rank, revealed slots, slot, card, scored and token flags) and the card
  knowledge (per seat from the observer and slot, the plausible bits, the
  known colour and rank).  The state tensor is the observation with the
  seat's own hand (one-hot card ids of its live slots) appended.
* **Turns**: only the seat to act, and on a reset every seat, is encoded
  again after a step; the other seats keep the bytes of their last
  encoding.  The seat to act is the active one.

Two departures from the Hanabi Learning Environment, as the reference C++
has them:

* the card-knowledge section repeats, over a slot's whole block of C * R
  plausible bits, one bit of the slot's plausible mask: the bit whose index
  is the seat's offset from the observer;
* the legality of a reveal scans every slot of the target's hand, dead
  slots (past the hand's size) included.
"""

from __future__ import annotations

import dataclasses

import torch

MASK32 = 0xFFFFFFFF
I32 = torch.int32
# the kinds of the last move, and 4: none yet
DISCARD, PLAY, REVEAL_COLOR, REVEAL_RANK, NONE = 0, 1, 2, 3, 4


@dataclasses.dataclass
class State:
    """One batch of games; every field has the world axis first.  Integer
    fields are int32 but ``hand_plausible`` and ``rng_v``, int64 holding
    uint32 values; -1 marks an absent player, slot, colour or rank.  The
    per-seat buffers hold each seat's last encoding."""
    deck: torch.Tensor            # [N, M] card ids
    deck_size: torch.Tensor       # [N]
    discard_counts: torch.Tensor  # [N, C*R]
    fireworks: torch.Tensor       # [N, C]
    info_tokens: torch.Tensor     # [N]
    life_tokens: torch.Tensor     # [N]
    cur_player: torch.Tensor      # [N]
    turns_to_play: torch.Tensor   # [N]
    score: torch.Tensor           # [N]
    lm_move: torch.Tensor         # [N]
    lm_player: torch.Tensor       # [N]
    lm_target: torch.Tensor       # [N]
    lm_card_index: torch.Tensor   # [N]
    lm_scored: torch.Tensor       # [N]
    lm_info_token: torch.Tensor   # [N]
    lm_color: torch.Tensor        # [N]
    lm_rank: torch.Tensor         # [N]
    lm_reveal_bits: torch.Tensor  # [N]
    hand_cards: torch.Tensor      # [N, P, H]
    hand_plausible: torch.Tensor  # [N, P, H]
    hand_size: torch.Tensor       # [N, P]
    known_color: torch.Tensor     # [N, P, H]
    known_rank: torch.Tensor      # [N, P, H]
    obs_buf: torch.Tensor         # [N, P, OBS] int8
    own_buf: torch.Tensor         # [N, P, H*C*R] int8
    mask_buf: torch.Tensor        # [N, P, A] bool
    rng_v: torch.Tensor           # [N]


FIELDS = tuple(f.name for f in dataclasses.fields(State))


def tea(idx: torch.Tensor) -> torch.Tensor:
    """The first LCG word of episode ``idx``: 8 rounds of TEA on (idx, 0)
    with the fixed key, v0 kept (uint32 in int64)."""
    key = (0xA341316C, 0xC8013EA4, 0xAD90777D, 0x7E95761E)
    v0 = idx.to(torch.int64) & MASK32
    v1 = torch.zeros_like(v0)
    total = 0
    for _ in range(8):
        total = (total + 0x9E3779B9) & MASK32
        v0 = (v0 + ((((v1 << 4) + key[0]) ^ (v1 + total) ^ ((v1 >> 5) + key[1]))
                    & MASK32)) & MASK32
        v1 = (v1 + ((((v0 << 4) + key[2]) ^ (v0 + total) ^ ((v0 >> 5) + key[3]))
                    & MASK32)) & MASK32
    return v0


def lcg(v: torch.Tensor) -> torch.Tensor:
    return (v * 1664525 + 1013904223) & MASK32


def draw_slot(v: torch.Tensor, size: torch.Tensor):
    """The next LCG word and ``int32(float32(size) * u)``, u its low 24 bits
    over 2^24."""
    v = lcg(v)
    u = (v & 0xFFFFFF).to(torch.float32) * (1.0 / 16777216.0)
    return v, (size.to(torch.float32) * u).to(I32)


def onehot(x: torch.Tensor, n: int) -> torch.Tensor:
    """``[..., n]`` bool, bit ``x`` set (none where x is outside 0..n-1)."""
    return x[..., None] == torch.arange(n, device=x.device)


def below(x: torch.Tensor, n: int) -> torch.Tensor:
    """``[..., n]`` bool thermometer: bit i set where i < x."""
    return torch.arange(n, device=x.device) < x[..., None]


class HanabiEnv:
    """One game's constants: ``colors``, ``ranks``, ``players``, the
    token counts, the hand size (5 below four players, else 4) and every
    section's width."""

    def __init__(self, colors, ranks, players, max_information_tokens, max_life_tokens):
        self.C, self.R, self.P = int(colors), int(ranks), int(players)
        self.max_info, self.max_life = int(max_information_tokens), int(max_life_tokens)
        self.H = 5 if self.P < 4 else 4
        C, R, P, H = self.C, self.R, self.P, self.H
        self.num_agents = P
        self.copies = [3] + [2] * (R - 2) + [1]  # of each rank, in a colour
        self.M = C * sum(self.copies)  # 50 in the full game
        self.deck_bits = self.M - P * H
        self.bpc = C * R
        self.obs_size = ((P - 1) * H * self.bpc + P                                   # hands
                         + self.deck_bits + C * R + self.max_info + self.max_life      # board
                         + self.M                                                      # discards
                         + P + 4 + P + C + R + H + H + C * R + 2                       # last move
                         + P * H * (self.bpc + C + R))                                 # knowledge
        self.state_size = self.obs_size + H * self.bpc
        self.num_actions = 2 * H + (P - 1) * (C + R)
        self.full_mask = (1 << self.bpc) - 1

    # ---- a fresh game -----------------------------------------------------
    def deal(self, episode: torch.Tensor) -> State:
        """Fresh games for the episode indices ``[N]``."""
        C, R, P, H, M = self.C, self.R, self.P, self.H, self.M
        dev = episode.device
        N = episode.shape[0]
        ids = [c * R + r for c in range(C) for r in range(R) for _ in range(self.copies[r])]
        deck = torch.tensor(ids, dtype=I32, device=dev).repeat(N, 1)
        rows = torch.arange(N, device=dev)
        v = tea(episode)
        cards = []
        for k in range(P * H):
            v, loc = draw_slot(v, torch.full((N,), M - k, dtype=I32, device=dev))
            loc = loc.long()
            cards.append(deck[rows, loc])
            deck[rows, loc] = deck[:, M - 1 - k]
        hand = torch.stack(cards, 1).reshape(N, P, H)

        def fill(shape, value, dtype=I32):
            return torch.full(shape, value, dtype=dtype, device=dev)

        return State(
            deck=deck, deck_size=fill((N,), M - P * H), discard_counts=fill((N, C * R), 0),
            fireworks=fill((N, C), 0), info_tokens=fill((N,), self.max_info),
            life_tokens=fill((N,), self.max_life), cur_player=fill((N,), 0),
            turns_to_play=fill((N,), P), score=fill((N,), 0), lm_move=fill((N,), NONE),
            lm_player=fill((N,), -1), lm_target=fill((N,), -1), lm_card_index=fill((N,), -1),
            lm_scored=fill((N,), 0), lm_info_token=fill((N,), 0), lm_color=fill((N,), -1),
            lm_rank=fill((N,), -1), lm_reveal_bits=fill((N,), 0), hand_cards=hand,
            hand_plausible=fill((N, P, H), self.full_mask, torch.int64),
            hand_size=fill((N, P), H), known_color=fill((N, P, H), -1),
            known_rank=fill((N, P, H), -1),
            obs_buf=fill((N, P, self.obs_size), 0, torch.int8),
            own_buf=fill((N, P, H * self.bpc), 0, torch.int8),
            mask_buf=fill((N, P, self.num_actions), False, torch.bool), rng_v=v)

    # ---- one move -----------------------------------------------------------
    def move(self, s: State, actions: torch.Tensor):
        """Every world's seat to act makes its move (``actions`` [N, P], the
        other seats' ignored).  Returns (state, reward [N] float32, done [N])."""
        C, R, P, H = self.C, self.R, self.P, self.H
        s = dataclasses.replace(s, **{f: getattr(s, f).clone() for f in FIELDS})
        N = s.deck.shape[0]
        dev = s.deck.device
        n = torch.arange(N, device=dev)
        slots = torch.arange(H, device=dev)
        s.turns_to_play -= (s.deck_size == 0).to(I32)
        actor = s.cur_player.long()
        uid = actions.to(I32)[n, actor]
        discard = uid < H
        play = (uid >= H) & (uid < 2 * H)
        took = discard | play
        rev_c = (uid >= 2 * H) & (uid < 2 * H + (P - 1) * C)
        rev_r = uid >= 2 * H + (P - 1) * C
        reveal = rev_c | rev_r

        # discard and play
        slot = torch.where(discard, uid, uid - H).clamp(0, H - 1).long()
        card = s.hand_cards[n, actor, slot]
        color, rank = card // R, card % R
        fw = s.fireworks[n, color.long()]
        scored = play & (fw == rank)
        completed = scored & (fw + 1 == R)
        failed = play & ~scored
        s.discard_counts[n, card.long()] += (discard | failed).to(I32)
        s.fireworks[n, color.long()] += scored.to(I32)
        s.info_tokens += discard.to(I32) + completed.to(I32) - reveal.to(I32)
        s.life_tokens -= failed.to(I32)

        # reveals: the partner at offset o, the colour or rank shown
        rc = (uid - 2 * H).clamp(min=0)
        rr = (uid - 2 * H - (P - 1) * C).clamp(min=0)
        offset = torch.where(rev_c, 1 + rc // C, 1 + rr // R)
        shown_c, shown_r = rc % C, rr % R
        target = ((actor + offset) % P).long()
        t_cards = s.hand_cards[n, target]
        t_live = slots < s.hand_size[n, target][:, None]
        hit = t_live & torch.where(rev_c[:, None], t_cards // R == shown_c[:, None],
                                   t_cards % R == shown_r[:, None])
        # the card ids of the shown colour, or of the shown rank
        cr = torch.arange(C * R, device=dev)
        kinds = torch.where(rev_c[:, None], cr // R == shown_c[:, None], cr % R == shown_r[:, None])
        bits = (kinds.to(torch.int64) << cr.to(torch.int64)).sum(1)[:, None]
        plaus = s.hand_plausible[n, target]
        narrowed = torch.where(hit, plaus & bits, plaus & ~bits & MASK32)
        s.hand_plausible[n, target] = torch.where(reveal[:, None], narrowed, plaus)
        s.known_color[n, target] = torch.where(rev_c[:, None] & hit, shown_c[:, None],
                                               s.known_color[n, target])
        s.known_rank[n, target] = torch.where(rev_r[:, None] & hit, shown_r[:, None],
                                              s.known_rank[n, target])

        # the last move
        none = torch.full_like(uid, -1)
        s.lm_move = torch.where(discard, DISCARD, torch.where(
            play, PLAY, torch.where(rev_c, REVEAL_COLOR, REVEAL_RANK))).to(I32)
        s.lm_player = actor.to(I32)
        s.lm_target = torch.where(reveal, target.to(I32), none)
        s.lm_card_index = torch.where(took, slot.to(I32), none)
        s.lm_scored = scored.to(I32)
        s.lm_info_token = completed.to(I32)
        s.lm_color = torch.where(took, color, torch.where(rev_c, shown_c, none))
        s.lm_rank = torch.where(took, rank, torch.where(rev_r, shown_r, none))
        s.lm_reveal_bits = torch.where(reveal, (hit.to(I32) << slots.to(I32)).sum(1, dtype=I32),
                                       torch.zeros_like(uid))
        s.cur_player = (s.cur_player + 1) % P

        # the taken slot refilled by a draw, or the hand shifted down
        draws = took & (s.deck_size > 0)
        shifts = took & (s.deck_size == 0)
        v, loc = draw_slot(s.rng_v, s.deck_size)
        loc = loc.long().clamp(0, self.M - 1)
        new_card = s.deck[n, loc]
        last = s.deck[n, (s.deck_size - 1).clamp(min=0).long()]
        s.deck[n, loc] = torch.where(draws, last, s.deck[n, loc])
        s.deck_size -= draws.to(I32)
        s.rng_v = torch.where(draws, v, s.rng_v)
        size = s.hand_size[n, actor]
        moved = (slots >= slot[:, None]) & (slots < (size - 1)[:, None])
        src = torch.where(moved, slots + 1, slots)
        at = slots == slot[:, None]
        for name, fresh in (("hand_cards", new_card[:, None]), ("hand_plausible", self.full_mask),
                            ("known_color", -1), ("known_rank", -1)):
            field = getattr(s, name)
            row = field[n, actor]
            row = torch.where(draws[:, None] & at, torch.as_tensor(fresh, dtype=row.dtype,
                                                                      device=dev), row)
            row = torch.where(shifts[:, None], row.gather(1, src), row)
            field[n, actor] = row
        s.hand_size[n, actor] -= shifts.to(I32)

        score = torch.where(s.life_tokens > 0, s.fireworks.sum(1, dtype=I32), 0)
        reward = (score - s.score).to(torch.float32)
        s.score = score
        done = (s.life_tokens <= 0) | (score >= C * R) | (s.turns_to_play <= 0)
        return s, reward, done

    # ---- encoding -----------------------------------------------------------
    def observe(self, s: State, a: int):
        """Seat ``a``'s observation [N, OBS] and own hand [N, H*C*R], int8."""
        C, R, P, H = self.C, self.R, self.P, self.H
        N = s.deck.shape[0]
        dev = s.deck.device
        slots = torch.arange(H, device=dev)
        live = slots < s.hand_size[:, :, None]  # [N, P, H]
        bits = []
        # the partners' hands, then the "hand not full" flags
        for i in range(1, P):
            q = (a + i) % P
            bits.append(onehot(s.hand_cards[:, q], self.bpc) & live[:, q, :, None])
        bits.append(torch.stack([s.hand_size[:, (a + i) % P] < H for i in range(P)], 1))
        # the board
        bits.append(below(s.deck_size, self.deck_bits))
        bits.append(onehot(s.fireworks - 1, R))
        bits.append(below(s.info_tokens, self.max_info))
        bits.append(below(s.life_tokens, self.max_life))
        # the discards: one bit a copy
        for cid in range(C * R):
            bits.append(below(s.discard_counts[:, cid], self.copies[cid % R]))
        # the last move
        kind = s.lm_move
        took = (kind == PLAY) | (kind == DISCARD)
        rev = (kind == REVEAL_COLOR) | (kind == REVEAL_RANK)
        bits.append(onehot(torch.where(s.lm_player < 0, -1, (a - s.lm_player) % P), P))
        bits.append(torch.stack([kind == PLAY, kind == DISCARD, kind == REVEAL_COLOR,
                                 kind == REVEAL_RANK], 1))
        bits.append(onehot((a - s.lm_target) % P, P) & rev[:, None])
        bits.append(onehot(s.lm_color, C) & (kind == REVEAL_COLOR)[:, None])
        bits.append(onehot(s.lm_rank, R) & (kind == REVEAL_RANK)[:, None])
        bits.append(((s.lm_reveal_bits[:, None] >> slots) & 1).bool() & rev[:, None])
        bits.append(onehot(s.lm_card_index, H) & took[:, None])
        bits.append(onehot(s.lm_color * R + s.lm_rank, C * R) & took[:, None])
        bits.append(torch.stack([(s.lm_scored != 0) & (kind == PLAY),
                                 (s.lm_info_token != 0) & (kind == PLAY)], 1))
        # the card knowledge, per seat from the observer and slot: one
        # plausible bit (its index the seat's offset) over the whole block
        for off in range(P):
            q = (a + off) % P
            lv = live[:, q, :, None]
            bit = ((s.hand_plausible[:, q] >> off) & 1).bool()[..., None]
            bits.append(torch.cat([(bit & lv).expand(N, H, self.bpc),
                                   onehot(s.known_color[:, q], C) & lv,
                                   onehot(s.known_rank[:, q], R) & lv], -1))
        obs = torch.cat([b.reshape(N, -1).to(torch.int8) for b in bits], 1)
        own = (onehot(s.hand_cards[:, a], self.bpc) & live[:, a, :, None]).reshape(N, -1)
        return obs, own.to(torch.int8)

    def legal(self, s: State, a: int) -> torch.Tensor:
        """Seat ``a``'s legal moves [N, A]: discard a live slot below the
        token cap, play a live slot, reveal (with a token) a colour or rank
        that some slot of the partner's hand holds, dead slots included."""
        C, R, P, H = self.C, self.R, self.P, self.H
        live = torch.arange(H, device=s.deck.device) < s.hand_size[:, a, None]
        tokens = (s.info_tokens > 0)[:, None]
        colors = [onehot(s.hand_cards[:, (a + i) % P] // R, C).any(1) & tokens for i in range(1, P)]
        ranks = [onehot(s.hand_cards[:, (a + i) % P] % R, R).any(1) & tokens for i in range(1, P)]
        return torch.cat([live & (s.info_tokens < self.max_info)[:, None], live] + colors + ranks,
                         1)

    def encode(self, s: State, reset: torch.Tensor):
        """Encode the seat to act, and every seat of the worlds in ``reset``;
        the others keep their bytes.  Returns (state, obs [N, P, OBS], state
        obs [N, P, OBS + H*C*R], mask [N, P, A], active [N, P])."""
        for a in range(self.P):
            fresh = (reset | (s.cur_player == a))
            obs, own = self.observe(s, a)
            f = fresh[:, None]
            s.obs_buf[:, a] = torch.where(f, obs, s.obs_buf[:, a])
            s.own_buf[:, a] = torch.where(f, own, s.own_buf[:, a])
            s.mask_buf[:, a] = torch.where(f, self.legal(s, a), s.mask_buf[:, a])
        active = torch.arange(self.P, device=s.deck.device) == s.cur_player[:, None]
        return (s, s.obs_buf.clone(), torch.cat([s.obs_buf, s.own_buf], -1), s.mask_buf.clone(),
                active)


def make_env(config: dict) -> HanabiEnv:
    g = config["game"]
    return HanabiEnv(g["colors"], g["ranks"], g["players"], g["max_information_tokens"],
                     g["max_life_tokens"])


def reset(env: HanabiEnv, num_envs: int, device):
    """Worlds 0..N-1 as episodes 0..N-1.  Returns (state, counter, obs,
    state obs, mask, active); the counter (a uint32 in an int64 scalar) is
    the next episode index."""
    s = env.deal(torch.arange(num_envs, dtype=torch.int64, device=device))
    s, obs, sobs, mask, active = env.encode(s, torch.ones(num_envs, dtype=torch.bool,
                                                          device=device))
    return (s, torch.tensor(num_envs & MASK32, dtype=torch.int64, device=device), obs, sobs,
            mask, active)


def step(env: HanabiEnv, s: State, counter: torch.Tensor, actions: torch.Tensor):
    """One step of every world with the auto-reset.  Returns (state,
    counter, obs, state obs, mask, active, reward [N, P] float32, done
    [N])."""
    s, reward, done = env.move(s, actions)
    d = done.to(torch.int64)
    episode = (counter + torch.cumsum(d, 0) - d) & MASK32
    counter = (counter + d.sum()) & MASK32
    fresh = env.deal(episode)
    for f in FIELDS:
        old, new = getattr(s, f), getattr(fresh, f)
        setattr(s, f, torch.where(done.reshape((-1,) + (1,) * (old.dim() - 1)), new, old))
    s, obs, sobs, mask, active = env.encode(s, done)
    return s, counter, obs, sobs, mask, active, reward[:, None].expand(-1, env.P), done
