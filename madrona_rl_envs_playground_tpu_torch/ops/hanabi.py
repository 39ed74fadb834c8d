"""Hanabi step, rollout and legal-move kernels and their plain PyTorch versions.

Counterpart of ``madrona_rl_envs_playground_tpu/ops/hanabi_megakernel.py``
and ``ops/hanabi_pallas.py``.  Three kernels, in ``csrc/hanabi.cu``: K3 and
K4 for the 2-player configs (``fused_supported``; games of more players
step on the plain env), K11 for every config:

* **K3** ``fused_step``: one game step per env (move resolution, the
  random-swap draw, termination, the world-order episode index of each
  reset and its deal, and the obs / own-hand / mask encodes of the
  refreshed seats, the other seats' bytes kept), in one launch: a refreshed
  seat's bytes come from the section table ``encode_table`` and the seat's
  values (``seat_values_plain`` and ``encodes_plain`` are the same
  formula);
* **K4** ``fused_rollout``: T steps in one cooperative launch, each env's
  action drawn uniformly over the active seat's legal moves from a per-env
  LCG (``action_from_mask`` replays the draw), a per-env done count and the
  checksum ``chk += P * reward + done + (sum of every seat's obs, own and
  mask bytes)`` after every step, a refreshed seat's sum in closed form
  (``seat_sums_plain``).  Instantiated for ``ROLLOUT_CONFIGS``; it carries
  each env in a packed record of int8 fields, so it checks its entry state
  against ``rollout_envelope`` (which holds every state the package's
  functions produce) on the card, with no host read: a launch whose state
  lies outside steps nothing, marks its outputs refused (done counts
  ``REFUSED_DCNT``, checksums ``REFUSED_CHK``) and fills the envelope word
  in mapped host memory, on which the next launch on that device or
  ``check_rollout_envelope`` raises ``ValueError``;
* **K11** ``legal_moves``: every seat's legal-move mask from the hand cards,
  hand sizes and info tokens, for any game of JAX's ``Env`` (``_mask_cfg``:
  2 to 5 players each with a compile-time instantiation, any other count
  with one that reads it at run time), colour and rank by floor division
  and modulo for every int32 card id, as JAX's ``//`` and ``%``.

Each wrapper launches its kernel for CUDA tensors and raises if it cannot;
for CPU tensors it runs its plain version (``fused_step_plain``,
``fused_rollout_plain``, ``legal_moves_plain``), built on the plain env.
Each call adds one to ``LAUNCHES[<wrapper name>]``; K11's calls count by
instantiation (``mask_launch_key``).

**Layout** (``TState``).  The game state is one int32 tensor ``st`` of
``[ROWS, N]``, the JAX kernel's rows stacked in its order, so a warp's loads
of one row are coalesced::

    deck [M] | discards [C*R] | fireworks [C] | 16 scalar rows (SCAL_FIELDS)
    | hand cards [P*H] | plausible [P*H] | hand sizes [P] | known color [P*H]
    | known rank [P*H]

(138 rows, 552 B per env, in the full config).  Hand rows are ``p * H + h``;
the plausible masks and the episode LCG word hold uint32 bits as int32.
The per-seat buffers are env-major, the layout the policy reads:
``obs [N, P, OBS]`` int8, ``own [N, P, H*C*R]`` int8 and ``mask [N, P, A]``
bool (JAX: ``[P, bits, N]``).  The per-step actions are ``[N, P]`` int32,
the reward is the int32 score delta ``[N]``; the rollout's action words are
``[1, N]`` as in JAX.  The episode counter is a uint32 held in an int64
scalar tensor on the state's device.

**Allocation order of K4.**  As K6 (``ops/cartpole.py``): per step in
whole-batch world order, which equals T applications of K3 and JAX's
``fused_rollout`` with ``block == N``.  JAX's multi-block grids allocate
block by block, so there the checksums differ from JAX's.  K4 returns the
launch-time obs / own / mask tensors, as JAX's kernel does.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Tuple

import torch

from ..core.batch import batched_reset, batched_step
from ..core.rng import _MASK32, _lcg_next, _tea_seed, _to_i32
from ..core.types import BatchState
from ..device import DeviceLike, resolve_device
from ..envs.hanabi import M_DISCARD, M_PLAY, M_REVEAL_C, M_REVEAL_R, Env, State
from . import _build

# launches of each kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"fused_step": 0, "fused_rollout": 0, "legal_moves_2p": 0,
                            "legal_moves_3p": 0, "legal_moves_4p": 0, "legal_moves_5p": 0,
                            "legal_moves_other": 0}

# the scalar rows, in the JAX kernel's order (hanabi_megakernel._SCAL_KEYS)
SCAL_FIELDS = ("deck_size", "info_tokens", "life_tokens", "cur_player", "turns_to_play",
               "score", "lm_move", "lm_player", "lm_target", "lm_card_index", "lm_scored",
               "lm_info_token", "lm_color", "lm_rank", "lm_reveal_bits", "rng_v")
CUR = SCAL_FIELDS.index("cur_player")
# the configs K4 is instantiated for (csrc/hanabi.cu's HK_ROLLOUT): full,
# small and very_small
ROLLOUT_CONFIGS = ("full", "small", "very_small")
INFO = SCAL_FIELDS.index("info_tokens")
# what a K4 launch refused for its entry state returns in every env
# (csrc/hanabi.cu's REFUSED_DCNT, REFUSED_CHK): a done count no rollout
# returns, and the checksum -2^31
REFUSED_DCNT = -1
REFUSED_CHK = -2**31
ENVELOPE_ERROR = "state outside hk_rollout_kernel's envelope (rollout_envelope): "


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def mask_launch_key(env: Env) -> str:
    """The ``LAUNCHES`` key of K11's instantiation for ``env``:
    ``hk_mask_kernel<P>`` for 2 to 5 players, ``<0>`` for any other count."""
    return f"legal_moves_{env.players}p" if 2 <= env.players <= 5 else "legal_moves_other"


def fused_supported(env: Env) -> bool:
    """2-player configs only (the reference's own 20-move envelope); games
    of more players stay on the plain env."""
    return env.players == 2


def row_offsets(env: Env) -> Dict[str, int]:
    """First row of each field of ``st`` and the total (``"rows"``)."""
    PH = env.players * env.hand
    sizes = (("deck", env.max_cards), ("disc", env.colors * env.ranks), ("fw", env.colors),
             ("scal", len(SCAL_FIELDS)), ("hc", PH), ("hp", PH), ("hs", env.players),
             ("kc", PH), ("kr", PH))
    out, r = {}, 0
    for name, n in sizes:
        out[name] = r
        r += n
    out["rows"] = r
    return out


@dataclasses.dataclass(frozen=True)
class TState:
    st: torch.Tensor    # [ROWS, N] int32
    obs: torch.Tensor   # [N, P, OBS] int8
    own: torch.Tensor   # [N, P, H*C*R] int8
    mask: torch.Tensor  # [N, P, A] bool

    @property
    def num_envs(self) -> int:
        return self.st.shape[1]


def pack_state(env: Env, s: State) -> TState:
    N = s.deck.shape[0]
    flat = lambda x: x.reshape(N, -1).t()
    scal = torch.stack([getattr(s, f) for f in SCAL_FIELDS[:-1]] + [_to_i32(s.rng_v)])
    st = torch.cat([flat(s.deck), flat(s.discard_counts), flat(s.fireworks), scal,
                    flat(s.hand_cards), flat(_to_i32(s.hand_plausible)), flat(s.hand_size),
                    flat(s.known_color), flat(s.known_rank)])
    return TState(st=st.contiguous(), obs=s.obs_buf.contiguous(),
                  own=s.own_buf.contiguous(), mask=s.mask_buf.contiguous())


def unpack_state(env: Env, ts: TState) -> State:
    P, H, N = env.players, env.hand, ts.num_envs
    off = row_offsets(env)
    rows = lambda name, n: ts.st[off[name]:off[name] + n].t().contiguous()
    hands = lambda name: rows(name, P * H).reshape(N, P, H)
    u32 = lambda x: x.to(torch.int64) & _MASK32
    fields = {f: ts.st[off["scal"] + i].clone() for i, f in enumerate(SCAL_FIELDS)}
    fields["rng_v"] = u32(fields["rng_v"])
    return State(deck=rows("deck", env.max_cards),
                 discard_counts=rows("disc", env.colors * env.ranks),
                 fireworks=rows("fw", env.colors),
                 hand_cards=hands("hc"), hand_plausible=u32(hands("hp")),
                 hand_size=rows("hs", P), known_color=hands("kc"), known_rank=hands("kr"),
                 obs_buf=ts.obs.clone(), own_buf=ts.own.clone(), mask_buf=ts.mask.clone(),
                 **fields)


def init_packed(env: Env, num_envs: int, start_episode: int = 0, device: DeviceLike = None):
    """Fresh games ``start_episode + w`` in the kernel layout; returns
    ``(TState, counter)``."""
    bstate, _ = batched_reset(env, num_envs, start_episode, device=device)
    return pack_state(env, bstate.env_states), bstate.episode_counter


def hand_inputs(env: Env, ts: TState):
    """K11's inputs read from the state: hand cards ``[N, P, H]``, hand sizes
    ``[N, P]`` and info tokens ``[N]``, int32."""
    off, N = row_offsets(env), ts.num_envs
    PH = env.players * env.hand
    cards = ts.st[off["hc"]:off["hc"] + PH].t().reshape(N, env.players, env.hand)
    return (cards.contiguous(), ts.st[off["hs"]:off["hs"] + env.players].t().contiguous(),
            ts.st[off["scal"] + INFO].contiguous())


# ---- the rollout kernel's action stream -----------------------------------

def init_action_rng(num_envs: int, seed: int = 0, device: DeviceLike = None) -> torch.Tensor:
    """[1, N] int32 action-LCG seeds: TEA of ``idx ^ 0x48414E41`` ("HANA")."""
    dev = resolve_device(device)
    idx = torch.arange(num_envs, dtype=torch.int64, device=dev) + seed * num_envs
    # the xor tag keeps this stream apart from every episode-RNG stream
    return _tea_seed(idx ^ 0x48414E41)[None, :]


def action_from_mask(w: torch.Tensor, mask: torch.Tensor):
    """The rollout kernel's legal draw.  ``w``: [N] int32 LCG words;
    ``mask``: [N, A] bool, the acting seat's legal moves.  Returns
    ``(w', uid [N] int32)``: w' = lcg(w), and uid is the
    ``(u24(w') * L) >> 24``-th legal move, L the number of legal moves and
    u24 bits 8..31 of w' (0 when no move is legal)."""
    w2 = _lcg_next(w)
    u24 = (w2.to(torch.int64) >> 8) & 0x00FFFFFF
    mi = mask.to(torch.int64)
    idx = (u24 * mi.sum(-1)) >> 24
    cum_before = torch.cumsum(mi, -1) - mi
    hit = mi * (cum_before == idx[..., None])
    uid = (torch.arange(mask.shape[-1], device=mask.device) * hit).sum(-1)
    return w2, uid.to(torch.int32)


def active_mask(env: Env, ts: TState) -> torch.Tensor:
    """[N, A] bool: the legal moves of the seat to act, from the state, as
    K4 and JAX's rollout kernel draw them (the mask buffer of a state K4
    returned is the launch-time one)."""
    cur = ts.st[row_offsets(env)["scal"] + CUR].long()
    legal = legal_moves_plain(env, *hand_inputs(env, ts))
    return legal[torch.arange(ts.num_envs, device=ts.st.device), cur]


# ---- plain versions --------------------------------------------------------

def fused_step_plain(env: Env, ts: TState, counter: torch.Tensor, actions: torch.Tensor):
    """K3's plain version: the plain env's ``batched_step``.  Returns
    ``(TState', reward delta [N] int32, done [N] bool, counter')``."""
    bstate = BatchState(env_states=unpack_state(env, ts), episode_counter=counter)
    bstate, out = batched_step(env, bstate, actions)
    return (pack_state(env, bstate.env_states), out.reward[:, 0].to(torch.int32), out.done,
            bstate.episode_counter)


def fused_rollout_plain(env: Env, ts: TState, counter: torch.Tensor, act_rng: torch.Tensor,
                        num_steps: int):
    """K4's plain version: ``num_steps`` plain steps, each env's action drawn
    by ``action_from_mask`` from the acting seat's mask.  Returns
    ``(TState', act_rng', counter', done_count [N] int32, checksum [N]
    int32)``; the returned obs / own / mask are the launch-time ones."""
    N, P = ts.num_envs, env.players
    dev = ts.st.device
    dcnt = torch.zeros(N, dtype=torch.int32, device=dev)
    chk = torch.zeros(N, dtype=torch.int32, device=dev)
    w, cur = act_rng[0], ts
    for _ in range(num_steps):
        w, uid = action_from_mask(w, active_mask(env, cur))
        cur, rew, done, counter = fused_step_plain(env, cur, counter,
                                                   uid[:, None].expand(N, P).contiguous())
        bufs = (cur.obs.reshape(N, -1).sum(1, dtype=torch.int32)
                + cur.own.reshape(N, -1).sum(1, dtype=torch.int32)
                + cur.mask.reshape(N, -1).sum(1, dtype=torch.int32))
        chk += rew * P + done.to(torch.int32) + bufs
        dcnt += done.to(torch.int32)
    out = TState(st=cur.st, obs=ts.obs, own=ts.own, mask=ts.mask)
    return out, w[None, :], counter, dcnt, chk


def copies_of_ranks(env: Env):
    """Copies of each card of rank r: 3 of rank 0, 1 of the top rank, 2 of
    the others."""
    R = env.ranks
    return [3 if r == 0 else 1 if r == R - 1 else 2 for r in range(R)]


def seat_sums_plain(env: Env, ts: TState) -> torch.Tensor:
    """Each seat's sum of the obs, own-hand and mask bytes that a fresh encode
    of the state ``ts.st`` would write, ``[N, P]`` int32, in closed form
    section by section (the formula K4 computes for a refreshed seat, after
    ``envs/hanabi.py::_encode_seat`` and ``legal_mask``): a one-hot block adds
    1 where its value lies in range, a thermometer the clamped count.  The
    reference's quirks stay: the knowledge section's plausible bit is bit
    ``offset`` of the mask broadcast over the slot's C*R bits, rel_target is
    taken even for lm_target -1 (the reveal flag gates it), and the reveal
    legality reads dead slots.  Two players."""
    C, R, P, H = env.colors, env.ranks, env.players, env.hand
    CR, N = C * R, ts.num_envs
    off = row_offsets(env)
    st = ts.st.to(torch.int64)
    rows = lambda name, n: st[off[name]:off[name] + n]
    sc = {f: st[off["scal"] + i] for i, f in enumerate(SCAL_FIELDS)}
    hc = rows("hc", P * H).reshape(P, H, N)
    hp = rows("hp", P * H).reshape(P, H, N) & 0xFFFFFFFF
    kc = rows("kc", P * H).reshape(P, H, N)
    kr = rows("kr", P * H).reshape(P, H, N)
    hs = rows("hs", P)
    slot = torch.arange(H, device=st.device)[:, None]
    live = slot[None] < hs[:, None]                                        # [P, H, N]
    in_range = lambda x, n: (x >= 0) & (x < n)
    cards = (live & in_range(hc, CR)).sum(1)                               # [P, N]
    copies = torch.tensor(copies_of_ranks(env) * C, device=st.device)[:, None]
    fw = rows("fw", C)
    lmm, lmc, lmr = sc["lm_move"], sc["lm_color"], sc["lm_rank"]
    is_reveal = (lmm == M_REVEAL_C) | (lmm == M_REVEAL_R)
    is_pd = (lmm == M_PLAY) | (lmm == M_DISCARD)
    is_play = lmm == M_PLAY
    shared = ((hs < H).sum(0) + sc["deck_size"].clamp(0, env.max_deck_bits)
              + ((fw >= 1) & (fw <= R)).sum(0)
              + sc["info_tokens"].clamp(0, env.max_info) + sc["life_tokens"].clamp(0, env.max_life)
              + torch.minimum(rows("disc", CR).clamp(min=0), copies).sum(0)
              + ((lmm >= M_DISCARD) & (lmm <= M_REVEAL_R)).long()
              + (is_reveal & in_range(lmc, C) & (lmm == M_REVEAL_C)).long()
              + (is_reveal & in_range(lmr, R) & (lmm == M_REVEAL_R)).long()
              + is_reveal * ((sc["lm_reveal_bits"] & ((1 << H) - 1))[None] >> slot & 1).sum(0)
              + (is_pd & in_range(sc["lm_card_index"], H)).long()
              + (is_pd & in_range(lmc * R + lmr, CR)).long()
              + (is_play & (sc["lm_scored"] != 0)).long()
              + (is_play & (sc["lm_info_token"] != 0)).long())
    hands = hc.permute(2, 0, 1).to(torch.int32).contiguous()
    legal = legal_moves_plain(env, hands, hs.t().to(torch.int32).contiguous(),
                              sc["info_tokens"].to(torch.int32))
    out = []
    for a in range(P):
        lmp = sc["lm_player"]
        # C's remainder (truncating), as the kernels compute it
        rel_actor = torch.where(lmp == -1, -1, torch.fmod(a - lmp + P, P))
        rel_target = torch.fmod(a - sc["lm_target"] + P, P)
        know = 0
        for o in range(P):
            k = (a + o) % P
            pb = live[k] & ((hp[k] >> o) & 1).bool()
            know = know + (CR * pb + (live[k] & in_range(kc[k], C))
                           + (live[k] & in_range(kr[k], R))).sum(0)
        out.append(shared + cards[1 - a] + cards[a] + know + in_range(rel_actor, P)
                   + (is_reveal & in_range(rel_target, P)) + legal[:, a].sum(1))
    return torch.stack(out, 1).to(torch.int32)


def value_layout(env: Env) -> Dict[str, int]:
    """The first index of each group of a seat's values (``seat_values_plain``;
    ``csrc/hanabi.cu``'s ``seat_values`` writes at these starts, which
    ``_cfg`` passes in this order) and their number (``"count"``): the
    partner's cards, the two hand-not-full flags, deck size, fireworks, info,
    life, discards, the last move's relative actor, kind, relative target,
    revealed colour and rank, reveal bits, card index and card, the scored
    and info-token flags, the knowledge blocks' plausible bits, known colours
    and known ranks, the own cards and the legal moves."""
    C, R, P, H = env.colors, env.ranks, env.players, env.hand
    sizes = (("pc", H), ("nf", 2), ("ds", 1), ("fw", C), ("info", 1), ("life", 1),
             ("disc", C * R), ("ra", 1), ("lmm", 1), ("rt", 1), ("rc", 1), ("rr", 1),
             ("rb", H), ("ci", 1), ("cid", 1), ("sc", 1), ("it", 1), ("pb", P * H),
             ("kc", P * H), ("kr", P * H), ("oc", H), ("lg", env.num_actions))
    out, i = {}, 0
    for name, n in sizes:
        out[name] = i
        i += n
    out["count"] = i
    return out


def encode_table(env: Env) -> torch.Tensor:
    """K3's section table: for each byte of a seat's obs, own hand and mask,
    in that order (``[OBS + H*C*R + A]`` int32), the value it reads and the
    range it tests, ``idx | lo << 8 | span << 16``: the byte is 1 where
    ``0 <= value - lo <= span``.  A one-hot byte tests ``value == k`` (lo k,
    span 0), a thermometer byte ``value > i`` (lo i + 1, span 127); the
    values are clamped to [-1, 64] (``seat_values_plain``), which keeps every
    test of a constant in 0..63.  Sections in ``envs/hanabi.py::_encode_seat``'s
    order."""
    C, R, P, H = env.colors, env.ranks, env.players, env.hand
    CR, v = C * R, value_layout(env)
    ent = []

    def eq(name, k, i=0):
        ent.append((v[name] + i, k, 0))

    def gt(name, k, i=0):
        ent.append((v[name] + i, k + 1, 127))

    for h in range(H):
        for b in range(CR):
            eq("pc", b, h)
    eq("nf", 1, 0)
    eq("nf", 1, 1)
    for i in range(env.max_deck_bits):
        gt("ds", i)
    for k in range(C):
        for r in range(R):
            eq("fw", r + 1, k)
    for i in range(env.max_info):
        gt("info", i)
    for i in range(env.max_life):
        gt("life", i)
    copies = copies_of_ranks(env)
    for k in range(CR):
        for i in range(copies[k % R]):
            gt("disc", i, k)
    for p in range(P):
        eq("ra", p)
    for m in (M_PLAY, M_DISCARD, M_REVEAL_C, M_REVEAL_R):
        eq("lmm", m)
    for p in range(P):
        eq("rt", p)
    for k in range(C):
        eq("rc", k)
    for r in range(R):
        eq("rr", r)
    for h in range(H):
        eq("rb", 1, h)
    for h in range(H):
        eq("ci", h)
    for k in range(CR):
        eq("cid", k)
    eq("sc", 1)
    eq("it", 1)
    for off in range(P):
        for h in range(H):
            for _ in range(CR):
                eq("pb", 1, off * H + h)
            for x in range(C):
                eq("kc", x, off * H + h)
            for r in range(R):
                eq("kr", r, off * H + h)
    if len(ent) != env.obs_size:
        raise AssertionError(f"the table covers {len(ent)} obs bytes, the config {env.obs_size}")
    for h in range(H):
        for b in range(CR):
            eq("oc", b, h)
    for k in range(env.num_actions):
        eq("lg", 1, k)
    if v["count"] > 255 or max(lo for _, lo, _ in ent) > 64:
        raise ValueError("the config's values or constants exceed the section table's bytes")
    return torch.tensor([i | lo << 8 | span << 16 for i, lo, span in ent], dtype=torch.int32)


def seat_values_plain(env: Env, ts: TState) -> torch.Tensor:
    """Every seat's values (``value_layout``) from the state ``ts.st``, ``[N,
    P, count]`` int8, each clamped to [-1, 64], as K3 computes them for a
    refreshed seat.  Two players."""
    C, R, P, H = env.colors, env.ranks, env.players, env.hand
    N, off = ts.num_envs, row_offsets(env)
    st = ts.st
    rows = lambda name, n: st[off[name]:off[name] + n]
    sc = {f: st[off["scal"] + i] for i, f in enumerate(SCAL_FIELDS)}
    hc, hs = rows("hc", P * H).reshape(P, H, N), rows("hs", P)
    hp = rows("hp", P * H).reshape(P, H, N)
    kc, kr = rows("kc", P * H).reshape(P, H, N), rows("kr", P * H).reshape(P, H, N)
    slot = torch.arange(H, device=st.device)[:, None]
    live = slot[None] < hs[:, None]                                        # [P, H, N]
    neg = torch.full_like(hc[0], -1)
    lmm, lmp, lmc, lmr = sc["lm_move"], sc["lm_player"], sc["lm_color"], sc["lm_rank"]
    is_reveal = (lmm == M_REVEAL_C) | (lmm == M_REVEAL_R)
    is_pd = (lmm == M_PLAY) | (lmm == M_DISCARD)
    is_play = lmm == M_PLAY
    legal = legal_moves_plain(env, hc.permute(2, 0, 1).contiguous(), hs.t().contiguous(),
                              sc["info_tokens"])
    seats = []
    for a in range(P):
        q = 1 - a
        know = [(a + o) % P for o in range(P)]
        parts = [
            torch.where(live[q], hc[q], neg),
            (hs[a] < H)[None], (hs[q] < H)[None], sc["deck_size"][None], rows("fw", C),
            sc["info_tokens"][None], sc["life_tokens"][None], rows("disc", C * R),
            # C's remainder (truncating), as the kernels compute it
            torch.where(lmp == -1, -1, torch.fmod(a - lmp + P, P))[None], lmm[None],
            torch.where(is_reveal, torch.fmod(a - sc["lm_target"] + P, P), -1)[None],
            torch.where(lmm == M_REVEAL_C, lmc, -1)[None],
            torch.where(lmm == M_REVEAL_R, lmr, -1)[None],
            is_reveal & ((sc["lm_reveal_bits"] >> slot) & 1).bool(),
            torch.where(is_pd, sc["lm_card_index"], -1)[None],
            torch.where(is_pd, lmc * R + lmr, -1)[None],
            (is_play & (sc["lm_scored"] != 0))[None], (is_play & (sc["lm_info_token"] != 0))[None],
            torch.cat([live[k] & ((hp[k] >> o) & 1).bool() for o, k in enumerate(know)]),
            torch.cat([torch.where(live[k], kc[k], neg) for k in know]),
            torch.cat([torch.where(live[k], kr[k], neg) for k in know]),
            torch.where(live[a], hc[a], neg),
            legal[:, a].t()]
        vals = torch.cat([x.to(torch.int32) for x in parts])                  # [count, N]
        seats.append(vals.clamp(-1, 64).to(torch.int8).t())
    return torch.stack(seats, 1)


def encodes_plain(env: Env, ts: TState):
    """Every seat's obs, own hand and mask written byte by byte from the
    section table and the seat values, as K3 writes a refreshed seat:
    ``(obs [N, P, OBS] int8, own [N, P, H*C*R] int8, mask [N, P, A] bool)``."""
    tab = encode_table(env).to(torch.int64)
    idx, lo, span = tab & 0xFF, (tab >> 8) & 0xFF, tab >> 16
    vals = seat_values_plain(env, ts).to(torch.int64)
    d = vals[..., idx.to(ts.st.device)] - lo.to(ts.st.device)
    bits = (d >= 0) & (d <= span.to(ts.st.device))
    o, w = env.obs_size, env.hand * env.bits_per_card
    return (bits[..., :o].to(torch.int8), bits[..., o:o + w].to(torch.int8),
            bits[..., o + w:].contiguous())


def rollout_envelope(env: Env):
    """The values K4's carry holds exactly, per row of ``st``: ``(lo, hi)``
    int64 ``[ROWS]``, None where any int32 is held or the row is rewritten by
    every step before it is read (the last-move rows).  Every state that
    ``init_packed``, ``fused_step`` and ``fused_rollout`` produce lies inside,
    and a game started inside stays inside (``csrc/hanabi.cu``'s header)."""
    C, R, P, H = env.colors, env.ranks, env.players, env.hand
    off, big = row_offsets(env), 2**31
    lo = torch.full((off["rows"],), -big, dtype=torch.int64)
    hi = torch.full((off["rows"],), big - 1, dtype=torch.int64)

    def put(name, n, low, high):
        lo[off[name]:off[name] + n], hi[off[name]:off[name] + n] = low, high

    put("deck", env.max_cards, 0, C * R - 1)
    put("disc", C * R, 0, torch.tensor(copies_of_ranks(env) * C))
    put("fw", C, 0, R)
    for f, low, high in (("deck_size", 0, env.max_deck_bits), ("info_tokens", 0, env.max_info + C),
                         ("life_tokens", 0, env.max_life), ("cur_player", 0, P - 1),
                         ("turns_to_play", 0, P), ("score", 0, C * R)):
        lo[off["scal"] + SCAL_FIELDS.index(f)] = low
        hi[off["scal"] + SCAL_FIELDS.index(f)] = high
    put("hc", P * H, 0, C * R - 1)
    put("hs", P, 0, H)
    put("kc", P * H, -1, C - 1)
    put("kr", P * H, -1, R - 1)
    return lo, hi


def envelope_violations(env: Env, st: torch.Tensor) -> List[str]:
    """Rows of ``st`` ([ROWS, N] int32) with a value outside
    ``rollout_envelope``: a list of ``"field[i]: min..max"`` strings (K4's
    check on the card in plain PyTorch; it reads the result on the host)."""
    lo, hi = (x.to(st.device) for x in rollout_envelope(env))
    mn, mx = torch.aminmax(st, dim=1)
    bad = torch.nonzero((mn.to(torch.int64) < lo) | (mx.to(torch.int64) > hi)).flatten().tolist()
    return violation_text(env, bad, mn.tolist(), mx.tolist())


def violation_text(env: Env, rows, mn, mx) -> List[str]:
    """``"field[i]: min..max"`` for each row index in ``rows`` of the state,
    ``mn`` and ``mx`` every row's min and max (sequences of ints)."""
    names = [(name, r) for name, r in row_offsets(env).items() if name != "rows"]
    out = []
    for row in rows:
        name, first = max((r, name) for name, r in names if r <= row)[::-1]
        field = SCAL_FIELDS[row - first] if name == "scal" else f"{name}[{row - first}]"
        out.append(f"{field}: {int(mn[row])}..{int(mx[row])}")
    return out


def envelope_word_ints(env: Env) -> int:
    """Ints of K4's envelope word for ``env`` (``csrc/hanabi.cu``'s
    ``envelope_ints``): the flag, the rows' bitmask, their mins, their
    maxes."""
    rows = row_offsets(env)["rows"]
    return 1 + (rows + 31) // 32 + 2 * rows


def word_violations(env: Env, word: torch.Tensor) -> List[str]:
    """The ``envelope_violations`` text of a filled envelope word (int32
    ``[envelope_word_ints(env)]`` on the host): the rows its bitmask marks,
    with their min and max over the batch."""
    rows = row_offsets(env)["rows"]
    nb = (rows + 31) // 32
    w = word.tolist()
    bad = [r for r in range(rows) if (w[1 + r // 32] >> (r % 32)) & 1]
    return violation_text(env, bad, w[1 + nb:1 + nb + rows], w[1 + nb + rows:])


def legal_moves_plain(env: Env, hand_cards: torch.Tensor, hand_size: torch.Tensor,
                      info_tokens: torch.Tensor) -> torch.Tensor:
    """K11's plain version: the plain env's mask for every seat, ``[N, P,
    A]`` bool."""
    return torch.stack([env.legal_mask(hand_cards, hand_size, info_tokens, a)
                        for a in range(env.players)], 1)


# ---- CUDA kernels ----------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("hanabi")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hk_scratch_ints.argtypes = [i]
        lib.hk_scratch_ints.restype = i
        lib.hk_step_scratch_ints.argtypes = [i]
        lib.hk_step_scratch_ints.restype = i
        lib.hk_step.argtypes = [p, i] + [p] * 15 + [i, i, p]
        lib.hk_step.restype = i
        lib.hk_rollout.argtypes = [p, i] + [p] * 15 + [i, i, i, p]
        lib.hk_rollout.restype = i
        lib.hk_envelope_ints.argtypes = [i]
        lib.hk_envelope_ints.restype = i
        lib.hk_envelope_record.argtypes = [i, i, ctypes.POINTER(p), ctypes.POINTER(p)]
        lib.hk_envelope_record.restype = i
        lib.hk_carry_bytes.argtypes = [p, i]
        lib.hk_rollout_onchip.argtypes = [p, i, i, i, p]
        lib.hk_rollout_onchip.restype = i
        lib.hk_carry_bytes.restype = i
        lib.hk_legal.argtypes = [p, i] + [p] * 4 + [i, i, p]
        lib.hk_legal.restype = i
        lib.hk_error_string.argtypes = [i]
        lib.hk_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _cfg(env: Env):
    """What the kernels read (``csrc/hanabi.cu``'s ``Cfg``, in its order):
    the config, its sizes, the row offsets of ``st`` and the first index of
    each group of a seat's values (``value_layout``, with the count last)."""
    if not fused_supported(env):
        raise ValueError("the hanabi kernels support 2-player configs")
    if env.colors * env.ranks > 32 or env.num_actions > 32:
        raise ValueError("the hanabi kernels hold the card values and the moves in 32-bit masks")
    off = row_offsets(env)
    vals = (env.colors, env.ranks, env.max_info, env.max_life, env.colors * env.ranks,
            env.cards_per_color, env.max_cards, env.max_deck_bits, env.obs_size,
            env.hand * env.bits_per_card, env.num_actions,
            *(off[k] for k in ("deck", "disc", "fw", "scal", "hc", "hp", "hs", "kc", "kr",
                               "rows")),
            *value_layout(env).values())
    return (ctypes.c_int * len(vals))(*vals), len(vals)


def _mask_cfg(env: Env):
    """What K11 reads (``csrc/hanabi.cu``'s ``MaskCfg``, in its order):
    players, hand size, colours, ranks, moves and info tokens at most.  Every
    game JAX's ``Env`` builds with a player and a rank fits: its moves (at
    most 60) fit K11's 64-bit word."""
    P, H, C, R, A = env.players, env.hand, env.colors, env.ranks, env.num_actions
    if P < 1 or R < 1 or C < 0 or A > 64:
        raise ValueError(f"hk_mask_kernel takes at least one player and one rank, no negative "
                         f"colour count and at most 64 moves, got {P} players, {C} colours, "
                         f"{R} ranks and {A} moves")
    vals = (P, H, C, R, A, env.max_info)
    return (ctypes.c_int * len(vals))(*vals), len(vals)


def _config_key(env: Env) -> tuple:
    return (env.colors, env.ranks, env.max_info, env.max_life, env.players)


# the kernels' tables on each device, per table and config
_DEVICE_TABLES: Dict[tuple, Dict[torch.device, torch.Tensor]] = {}


def _cached_table(name: str, env: Env, dev: torch.device, build) -> torch.Tensor:
    per_dev = _DEVICE_TABLES.setdefault((name, _config_key(env)), {})
    t = per_dev.get(dev)
    if t is None:
        t = per_dev[dev] = build().to(dev)
    return t


def _device_table(env: Env, dev: torch.device) -> torch.Tensor:
    """``encode_table(env)`` on ``dev``, which K3 reads; copied once."""
    return _cached_table("encode", env, dev, lambda: encode_table(env))


def envelope_table(env: Env, dev: DeviceLike = None) -> torch.Tensor:
    """``rollout_envelope(env)`` as K4 reads it: int32 ``[2 * ROWS]``, every
    row's lo, then every row's hi (a row with no bound holds the int32
    range); copied to ``dev`` once."""
    return _cached_table("envelope", env, _indexed(dev),
                         lambda: torch.cat(rollout_envelope(env)).to(torch.int32))


def _indexed(device: DeviceLike) -> torch.device:
    """``resolve_device(device)`` with a card's index (``"cuda"`` is the
    current card), as a tensor's ``.device`` names it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class EnvelopeWord:
    """K4's envelope word for one config on one device: ``words`` (int32
    ``[envelope_word_ints(env)]``) on the host, in pinned memory that the
    card writes through ``device_ptr`` (never freed: a word lives as long
    as the process); a refused launch sets ``words[0]`` to 1 after the
    rest.  ``flag`` reads that first int without a CUDA call."""
    env: Env
    words: torch.Tensor
    device_ptr: int

    def __post_init__(self):
        self.flag = ctypes.c_int32.from_address(self.words.data_ptr())


# the envelope words, per (config, device); written by the card, read and
# cleared by _raise_refused
_ENVELOPE_WORDS: Dict[Tuple[tuple, torch.device], EnvelopeWord] = {}


def _envelope_word(env: Env, dev: torch.device) -> EnvelopeWord:
    key = (_config_key(env), dev)
    rec = _ENVELOPE_WORDS.get(key)
    if rec is None:
        lib, rows = _lib(), row_offsets(env)["rows"]
        n = lib.hk_envelope_ints(rows)
        if n != envelope_word_ints(env):
            raise RuntimeError(f"hk_envelope_ints({rows}) is {n}, envelope_word_ints "
                               f"{envelope_word_ints(env)}")
        host, device_ptr = ctypes.c_void_p(), ctypes.c_void_p()
        _raise_on(lib.hk_envelope_record(rows, dev.index or 0, ctypes.byref(host),
                                         ctypes.byref(device_ptr)), "hk_envelope_record")
        words = torch.frombuffer((ctypes.c_int32 * n).from_address(host.value),
                                 dtype=torch.int32)
        rec = _ENVELOPE_WORDS[key] = EnvelopeWord(env, words, device_ptr.value)
    return rec


def _raise_refused(dev: torch.device, wait: bool) -> None:
    """Raise ``ValueError`` (``ENVELOPE_ERROR`` and ``envelope_violations``'
    text) for every filled envelope word of ``dev``, and clear them.  With
    ``wait`` the device is synchronised first, so every launch so far has
    written its word; without, the words are read as they stand (no CUDA
    call) and the device is synchronised only once one is filled."""
    words = [w for (_, d), w in _ENVELOPE_WORDS.items() if d == dev]
    if not words or (not wait and not any(w.flag.value for w in words)):
        return
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    filled = [w for w in words if w.flag.value]
    if not filled:
        return
    text = [t for w in filled for t in word_violations(w.env, w.words)]
    for w in filled:
        w.words.zero_()
    raise ValueError(ENVELOPE_ERROR + "; ".join(text))


def check_rollout_envelope(device: DeviceLike = None) -> None:
    """Raise ``ValueError`` if a K4 launch on ``device`` was refused for its
    entry state (outside ``rollout_envelope``) since the last report: the
    message names each row outside and its min and max over the batch, as
    ``envelope_violations`` does.  Waits for the device first; returns
    quietly where no launch was refused (and on the CPU, where
    ``fused_rollout`` runs its plain version)."""
    _raise_refused(_indexed(device), wait=True)


def _check_state(env: Env, ts: TState, counter: torch.Tensor) -> int:
    N = ts.st.shape[1] if ts.st.dim() == 2 else -1
    if N <= 0:
        raise ValueError(f"st must be a non-empty [ROWS, N] tensor, got {tuple(ts.st.shape)}")
    dev, P = ts.st.device, env.players
    _build.check_tensor(ts.st, "st", torch.int32, (row_offsets(env)["rows"], N), dev)
    _build.check_tensor(ts.obs, "obs", torch.int8, (N, P, env.obs_size), dev)
    _build.check_tensor(ts.own, "own", torch.int8, (N, P, env.hand * env.bits_per_card), dev)
    _build.check_tensor(ts.mask, "mask", torch.bool, (N, P, env.num_actions), dev)
    _build.check_tensor(counter, "counter", torch.int64, (), dev, align=8)
    return N


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().hk_error_string(rc).decode()
        raise RuntimeError(f"{what} failed to launch: error {rc} ({msg})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _fused_step_cuda(env: Env, ts: TState, counter: torch.Tensor, actions: torch.Tensor):
    N = _check_state(env, ts, counter)
    dev = ts.st.device
    _build.check_tensor(actions, "actions", torch.int32, (N, env.players), dev, align=4)
    cfg, lib = _cfg(env), _lib()
    out = TState(st=torch.empty_like(ts.st), obs=torch.empty_like(ts.obs),
                 own=torch.empty_like(ts.own), mask=torch.empty_like(ts.mask))
    rew = torch.empty(N, dtype=torch.int32, device=dev)
    done = torch.empty(N, dtype=torch.bool, device=dev)
    cnt = torch.empty_like(counter)
    scratch = torch.empty(lib.hk_step_scratch_ints(N), dtype=torch.int32, device=dev)
    rc = lib.hk_step(
        *cfg, ts.st.data_ptr(), ts.obs.data_ptr(), ts.own.data_ptr(), ts.mask.data_ptr(),
        actions.data_ptr(), counter.data_ptr(), _device_table(env, dev).data_ptr(),
        out.st.data_ptr(), out.obs.data_ptr(), out.own.data_ptr(), out.mask.data_ptr(),
        rew.data_ptr(), done.data_ptr(), cnt.data_ptr(), scratch.data_ptr(), N, dev.index or 0,
        _stream(dev))
    _raise_on(rc, "hk_step_kernel")
    LAUNCHES["fused_step"] += 1
    return out, rew, done, cnt


def _fused_rollout_cuda(env: Env, ts: TState, counter: torch.Tensor, act_rng: torch.Tensor,
                        num_steps: int):
    N = _check_state(env, ts, counter)
    dev = ts.st.device
    _build.check_tensor(act_rng, "act_rng", torch.int32, (1, N), dev, align=4)
    cfg, lib = _cfg(env), _lib()
    record = lib.hk_carry_bytes(*cfg)
    if record < 0:
        raise ValueError(f"hk_rollout_kernel has no instantiation for this config "
                         f"({env.colors} colors, {env.ranks} ranks): it runs {ROLLOUT_CONFIGS}")
    # an earlier launch refused on this device raises here, if its word is
    # written by now; this launch's check runs on the card
    _raise_refused(dev, wait=False)
    word = _envelope_word(env, dev)
    st, arng = torch.empty_like(ts.st), torch.empty_like(act_rng)
    dcnt = torch.empty(N, dtype=torch.int32, device=dev)
    chk = torch.empty(N, dtype=torch.int32, device=dev)
    cnt = torch.empty_like(counter)
    carry = torch.empty(N * record, dtype=torch.uint8, device=dev)
    scratch = torch.empty(lib.hk_scratch_ints(N), dtype=torch.int32, device=dev)
    rc = lib.hk_rollout(
        *cfg, ts.st.data_ptr(), ts.obs.data_ptr(), ts.own.data_ptr(), ts.mask.data_ptr(),
        act_rng.data_ptr(), counter.data_ptr(), envelope_table(env, dev).data_ptr(),
        st.data_ptr(), arng.data_ptr(), dcnt.data_ptr(), chk.data_ptr(), cnt.data_ptr(),
        carry.data_ptr(), scratch.data_ptr(), word.device_ptr, N, int(num_steps),
        dev.index or 0, _stream(dev))
    _raise_on(rc, "hk_rollout_kernel")
    LAUNCHES["fused_rollout"] += 1
    return TState(st=st, obs=ts.obs, own=ts.own, mask=ts.mask), arng, cnt, dcnt, chk


def rollout_kernel(env: Env, num_envs: int, device: DeviceLike = None) -> str:
    """The K4 kernel ``fused_rollout`` launches for ``num_envs`` envs of
    ``env`` on the card ``device``, by shape: ``hk_rollout_onchip_kernel``
    where the resident grid holds every env's records in shared memory, else
    ``hk_rollout_kernel``, whose records lie in device memory."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the rollout kernels run on a CUDA device")
    onchip = ctypes.c_int(0)
    rc = _lib().hk_rollout_onchip(*_cfg(env), int(num_envs), dev.index or 0,
                                  ctypes.byref(onchip))
    _raise_on(rc, "hk_rollout_onchip")
    return "hk_rollout_onchip_kernel" if onchip.value else "hk_rollout_kernel"


def _check_hands(env: Env, hand_cards, hand_size, info_tokens) -> int:
    N = hand_cards.shape[0] if hand_cards.dim() == 3 else -1
    if N <= 0:
        raise ValueError(f"hand_cards must be a non-empty [N, P, H] tensor, "
                         f"got {tuple(hand_cards.shape)}")
    dev, P = hand_cards.device, env.players
    _build.check_tensor(hand_cards, "hand_cards", torch.int32, (N, P, env.hand), dev, align=4)
    _build.check_tensor(hand_size, "hand_size", torch.int32, (N, P), dev, align=4)
    _build.check_tensor(info_tokens, "info_tokens", torch.int32, (N,), dev, align=4)
    return N


def _legal_moves_cuda(env: Env, hand_cards, hand_size, info_tokens):
    N = _check_hands(env, hand_cards, hand_size, info_tokens)
    dev = hand_cards.device
    cfg, lib = _mask_cfg(env), _lib()
    out = torch.empty((N, env.players, env.num_actions), dtype=torch.bool, device=dev)
    rc = lib.hk_legal(*cfg, hand_cards.data_ptr(), hand_size.data_ptr(), info_tokens.data_ptr(),
                      out.data_ptr(), N, dev.index or 0, _stream(dev))
    _raise_on(rc, "hk_mask_kernel")
    LAUNCHES[mask_launch_key(env)] += 1
    return out


def fused_step(env: Env, ts: TState, counter: torch.Tensor, actions: torch.Tensor):
    """One step of every env.  ``actions``: int32 ``[N, P]`` (only the
    current player's is read).  Returns ``(TState', reward delta [N] int32,
    done [N] bool, counter')``.

    K3 on CUDA tensors; the plain version on CPU tensors."""
    if ts.st.is_cuda:
        return _fused_step_cuda(env, ts, counter, actions)
    _check_state(env, ts, counter)
    return fused_step_plain(env, ts, counter, actions)


def fused_rollout(env: Env, ts: TState, counter: torch.Tensor, act_rng: torch.Tensor,
                  num_steps: int):
    """``num_steps`` steps of every env in one launch, actions drawn from the
    per-env LCG ``act_rng`` (``init_action_rng``) over the acting seat's
    legal moves.  Returns ``(TState', act_rng', counter', done_count [N]
    int32, checksum [N] int32)``; the returned obs / own / mask are the
    launch-time tensors.

    K4 on CUDA tensors; the plain version on CPU tensors.  On the card the
    call returns without waiting for the device: K4 checks the state
    against ``rollout_envelope`` itself.  A launch whose state lies outside
    steps nothing and returns the state, action words and counter as given,
    every done count ``REFUSED_DCNT`` (-1) and every checksum
    ``REFUSED_CHK`` (-2^31); its rows and their ranges reach the host in the
    envelope word, on which the next ``fused_rollout`` on that device (once
    the refused launch has run) or ``check_rollout_envelope`` raises
    ``ValueError`` with ``envelope_violations``' text.  A refused state
    passed on is refused again."""
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    if ts.st.is_cuda:
        return _fused_rollout_cuda(env, ts, counter, act_rng, num_steps)
    _check_state(env, ts, counter)
    return fused_rollout_plain(env, ts, counter, act_rng, num_steps)


def legal_moves(env: Env, hand_cards: torch.Tensor, hand_size: torch.Tensor,
                info_tokens: torch.Tensor) -> torch.Tensor:
    """Every seat's legal moves ``[N, P, A]`` bool from the hand cards
    ``[N, P, H]``, hand sizes ``[N, P]`` and info tokens ``[N]`` (int32, any
    values; 4-byte-aligned views are taken), for any config ``_mask_cfg``
    takes.

    K11 on CUDA tensors; the plain version on CPU tensors."""
    if hand_cards.is_cuda:
        return _legal_moves_cuda(env, hand_cards, hand_size, info_tokens)
    _check_hands(env, hand_cards, hand_size, info_tokens)
    return legal_moves_plain(env, hand_cards, hand_size, info_tokens)
