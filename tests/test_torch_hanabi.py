"""The port's Hanabi env and the plain versions of K3, K4 and K11 against
the JAX package.

Inputs come from numpy seeds; both sides run on the CPU; the JAX kernels
run in Pallas interpret mode, as ``tests/test_hanabi_megakernel.py`` runs
them.  Hanabi is integer arithmetic apart from one float32 multiply in each
draw position, which both sides round the same way, so every comparison
here is exact: obs, own hand, state tensor, mask, active flags, reward,
done, every state field, the episode counter and the action LCG.  The CUDA
kernels run only on the card, where ``chip_smoke.py`` holds them against
these plain versions.
"""

import itertools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.core.batch import batched_reset as j_reset
from madrona_rl_envs_playground_tpu.core.batch import batched_step as j_step
from madrona_rl_envs_playground_tpu.envs import hanabi as jh
from madrona_rl_envs_playground_tpu.ops import hanabi_megakernel as jk
from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset as t_reset
from madrona_rl_envs_playground_tpu_torch.core.batch import batched_step as t_step
from madrona_rl_envs_playground_tpu_torch.envs import hanabi as th
from madrona_rl_envs_playground_tpu_torch.ops import hanabi as tk
from madrona_rl_envs_playground_tpu_torch.train.fused_collect import make_fused_collect

CPU = torch.device("cpu")
# one compile of the whole reset per (env, N, start): run eagerly, JAX
# compiles each of its many small operations per shape, ~6x slower here
J_RESET = jax.jit(j_reset, static_argnums=(0, 1, 2))
THREE_PLAYERS = dict(colors=2, ranks=5, players=3, max_information_tokens=3, max_life_tokens=2)
OUT_FIELDS = ("obs", "state_obs", "action_mask", "active", "reward", "done")


def legal_actions(rs, mask, allowed=None):
    """A uniform legal move per (env, seat) from the bool mask [N, P, A];
    ``allowed(uid)`` narrows the choice where it leaves a legal move."""
    N, P, _ = mask.shape
    out = np.zeros((N, P), np.int32)
    for i in range(N):
        for p in range(P):
            legal = np.nonzero(mask[i, p])[0]
            if allowed is not None and any(allowed(u) for u in legal):
                legal = [u for u in legal if allowed(u)]
            out[i, p] = rs.choice(legal) if len(legal) else 0
    return out


def assert_state(t_state, j_state, msg):
    for f in j_state.__dataclass_fields__:
        got, ref = getattr(t_state, f).numpy(), np.asarray(getattr(j_state, f))
        if ref.dtype == np.uint32:  # hand_plausible, rng_v: int64 in the port
            assert got.dtype == np.int64, f
            ref = ref.astype(np.int64)
        assert got.dtype == ref.dtype and got.shape == ref.shape, (f, got.dtype, ref.dtype)
        np.testing.assert_array_equal(got, ref, err_msg=f"{msg} {f}")


@pytest.mark.parametrize("config,n,steps,start,seed,allowed", [
    ("full", 37, 60, 0, 0, None),
    ("small", 37, 60, 5, 1, None),
    ("very_small", 37, 60, 2**32 - 37 - 30, 2, None),  # the counter wraps
    ("three_players", 16, 60, 0, 5, None),
    # never play: the deck drains through discards, so hands shrink by the
    # empty-deck shift and turns_to_play counts down
    ("full", 8, 140, 0, 3, "no_play"),
])
def test_plain_env_matches_jax_batched_step(config, n, steps, start, seed, allowed):
    cfg = THREE_PLAYERS if config == "three_players" else jh.CONFIGS[config]
    je, te = jh.Env(**cfg), th.Env(**cfg)
    assert (te.obs_size, te.state_size, te.num_actions) == (je.obs_size, je.state_size,
                                                            je.num_actions)
    H = te.hand
    keep = (lambda u: not (H <= u < 2 * H)) if allowed == "no_play" else None
    j_bs, j_out = J_RESET(je, n, start)
    t_bs, t_out = t_reset(te, n, start, device=CPU)
    assert_state(t_bs.env_states, j_bs.env_states, "reset")
    step = jax.jit(j_step, static_argnums=(0,))
    rs = np.random.RandomState(seed)
    resets, shrunk = 0, False
    for t in range(steps):
        acts = legal_actions(rs, np.asarray(j_out.action_mask), keep)
        j_bs, j_out = step(je, j_bs, jnp.asarray(acts))
        t_bs, t_out = t_step(te, t_bs, torch.from_numpy(acts))
        for f in OUT_FIELDS:
            got, ref = getattr(t_out, f).numpy(), np.asarray(getattr(j_out, f))
            assert got.dtype == ref.dtype and got.shape == ref.shape, (f, got.dtype, ref.dtype)
            np.testing.assert_array_equal(got, ref, err_msg=f"t={t} {f}")
        assert_state(t_bs.env_states, j_bs.env_states, f"t={t}")
        assert int(t_bs.episode_counter) == int(j_bs.episode_counter), t
        resets += int(t_out.done.sum())
        shrunk |= bool((t_bs.env_states.hand_size < H).any())
    assert resets > 0
    if allowed == "no_play":
        assert shrunk, "the deck never emptied"
    if start > 2**31:
        assert int(t_bs.episode_counter) < start  # wrapped


def test_full_config_sizes():
    env = th.Env(**th.CONFIGS["full"])
    assert (env.obs_size, env.state_size, env.num_actions, env.max_cards) == (658, 783, 20, 50)
    assert th.NUM_MOVES_MAX == 60 and set(th.CONFIGS) == {"full", "small", "very_small"}
    assert env.masked and not env.state_is_obs
    assert tk.row_offsets(env)["rows"] == 138


def _to_jax(env, ts: tk.TState):
    """The port's layout -> the JAX kernel's dict of [rows, N] blocks and
    [P, bits, N] buffers."""
    off, st = tk.row_offsets(env), ts.st.numpy()
    names = ("deck", "disc", "fw", "scal", "hc", "hp", "hs", "kc", "kr")
    ends = [off[k] for k in names[1:]] + [off["rows"]]
    d = {k: jnp.asarray(st[off[k]:e]) for k, e in zip(names, ends)}
    d["obs"] = jnp.asarray(ts.obs.numpy().transpose(1, 2, 0))
    d["own"] = jnp.asarray(ts.own.numpy().transpose(1, 2, 0))
    d["mask"] = jnp.asarray(ts.mask.numpy().transpose(1, 2, 0).astype(np.int8))
    return d


def _assert_packed(env, t_ts, j_d, msg):
    want = _to_jax(env, t_ts)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), np.asarray(j_d[k]),
                                      err_msg=f"{msg} {k}")


def _j_init_packed(env, n, start=0):
    """``hanabi_megakernel.init_packed`` through the jitted reset."""
    return jk.pack_state(env, J_RESET(env, n, start)[0].env_states), jnp.int32(start + n)


def test_step_plain_matches_jax_fused_step():
    """K3's plain version against the JAX kernel (interpret mode, one block
    of 8), actions drawn by ``action_from_mask`` from the acting seat's mask
    on both sides; every state row, buffer, reward, done and the counter."""
    env_j, env_t = jh.Env(**jh.CONFIGS["very_small"]), th.Env(**th.CONFIGS["very_small"])
    n = 8
    ts, cnt = tk.init_packed(env_t, n, device=CPU)
    d, j_cnt = _j_init_packed(env_j, n)
    _assert_packed(env_t, ts, d, "init")
    step = jax.jit(lambda d_, c_, a_: jk.fused_step(env_j, d_, c_, a_, block=n, interpret=True))
    w, j_w = tk.init_action_rng(n, seed=1, device=CPU)[0], jk.init_action_rng(n, seed=1)[0]
    resets = 0
    for t in range(40):
        mask = tk.active_mask(env_t, ts)
        w, uid = tk.action_from_mask(w, mask)
        j_w, j_uid = jk.action_from_mask(j_w, jnp.asarray(mask.numpy()))
        np.testing.assert_array_equal(uid.numpy(), np.asarray(j_uid), err_msg=f"t={t} uid")
        acts = uid[:, None].expand(n, 2).contiguous()
        ts, rew, done, cnt = tk.fused_step(env_t, ts, cnt, acts)
        d, j_rew, j_done, j_cnt = step(d, j_cnt, jnp.asarray(acts.numpy().T))
        _assert_packed(env_t, ts, d, f"t={t}")
        np.testing.assert_array_equal(rew.numpy(), np.asarray(j_rew), err_msg=f"t={t} reward")
        np.testing.assert_array_equal(done.numpy(), np.asarray(j_done), err_msg=f"t={t} done")
        assert rew.dtype == torch.int32 and done.dtype == torch.bool
        assert int(cnt) == int(j_cnt), t
        resets += int(done.sum())
    np.testing.assert_array_equal(w.numpy(), np.asarray(j_w))
    assert resets > n


def test_rollout_plain_matches_jax_fused_rollout_one_block():
    """K4's plain version allocates per step in world order, which is JAX's
    fused_rollout with one block (block == N): the final state, counter,
    action words, done count and checksum exactly, and the launch-time
    buffers returned."""
    env_j, env_t = jh.Env(**jh.CONFIGS["very_small"]), th.Env(**th.CONFIGS["very_small"])
    n, T = 8, 40
    ts, cnt = tk.init_packed(env_t, n, device=CPU)
    w = tk.init_action_rng(n, seed=2, device=CPU)
    d, j_cnt = _j_init_packed(env_j, n)
    j_w = jk.init_action_rng(n, seed=2)
    np.testing.assert_array_equal(w.numpy(), np.asarray(j_w))
    j_d, j_cnt, j_w, j_dcnt, j_chk = jax.jit(lambda d_, c_, w_: jk.fused_rollout(
        env_j, d_, c_, w_, T, block=n, interpret=True))(d, j_cnt, j_w)
    t_ts, t_w, t_cnt, t_dcnt, t_chk = tk.fused_rollout(env_t, ts, cnt, w, T)
    _assert_packed(env_t, t_ts, j_d, "final")
    assert t_ts.obs is ts.obs and t_ts.mask is ts.mask
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    np.testing.assert_array_equal(t_dcnt.numpy(), np.asarray(j_dcnt))
    np.testing.assert_array_equal(t_chk.numpy(), np.asarray(j_chk))
    assert int(t_cnt) == int(j_cnt)
    assert t_dcnt.dtype == torch.int32 and t_chk.dtype == torch.int32
    assert int(t_dcnt.sum()) > n


# K11's envelope: 2 to 5 players, reachable hands (card ids in [0, C*R),
# sizes 0..H, info 0..max_info) and arbitrary int32 inputs ("wild_")
MASK_CONFIGS = {"full": jh.CONFIGS["full"], "small": jh.CONFIGS["small"],
                "three_players": THREE_PLAYERS,
                "full_4p": dict(jh.CONFIGS["full"], players=4),
                "full_5p": dict(jh.CONFIGS["full"], players=5)}


def wild_hands(rs, n, env):
    """Arbitrary int32 hand cards, sizes and info tokens: a third of the card
    ids across int32, the rest around [0, C*R) (negative ones and ones >=
    C*R among them), the int32 extremes; sizes -1..H+1 and info
    -1..max_info+1, with the extremes too."""
    P, H, CR = env.players, env.hand, env.colors * env.ranks
    i32 = np.iinfo(np.int32)
    cards = rs.randint(-2 * CR, 3 * CR, size=(n, P, H)).astype(np.int64)
    wide = rs.rand(n, P, H) < 1 / 3
    cards[wide] = rs.randint(i32.min, i32.max, size=int(wide.sum()), dtype=np.int64)
    cards[0, 0, :3] = (i32.min, i32.max, -1)
    size = rs.randint(-1, H + 2, size=(n, P))
    size[1, :2] = (i32.min, i32.max)
    info = rs.randint(-1, env.max_info + 2, size=n)
    info[2:4] = (i32.min, i32.max)
    return cards.astype(np.int32), size.astype(np.int32), info.astype(np.int32)


@pytest.mark.parametrize("config", ["full", "small", "three_players", "full_4p", "full_5p",
                                    "wild_full", "wild_full_5p"])
def test_legal_moves_plain_matches_jax_mask_seat(config):
    """K11's plain version against the JAX env's ``_mask_seat`` for every
    seat, on random hands with dead slots (what ``tests/test_pallas_ops.py``
    holds the TPU kernel against), and on arbitrary int32 inputs, where
    colour and rank are floor division and modulo."""
    wild = config.startswith("wild_")
    cfg = MASK_CONFIGS[config[5:] if wild else config]
    je, te = jh.Env(**cfg), th.Env(**cfg)
    n, P, H = (256 if wild else 64), te.players, te.hand
    rs = np.random.RandomState(8)
    if wild:
        cards, size, info = wild_hands(rs, n, te)
        assert (cards < 0).any() and (cards >= te.colors * te.ranks).any()
    else:
        cards = rs.randint(0, te.colors * te.ranks, size=(n, P, H)).astype(np.int32)
        size = rs.randint(0, H + 1, size=(n, P)).astype(np.int32)
        info = rs.randint(0, te.max_info + 1, size=n).astype(np.int32)
    got = tk.legal_moves(te, torch.from_numpy(cards), torch.from_numpy(size),
                         torch.from_numpy(info))
    assert got.dtype == torch.bool and got.shape == (n, P, te.num_actions)
    # _mask_seat reads only these three fields of its state
    mask_seat = jax.jit(jax.vmap(lambda c, s, i, a: je._mask_seat(
        SimpleNamespace(hand_cards=c, hand_size=s, info_tokens=i), a),
        in_axes=(0, 0, 0, None)))
    for a in range(P):
        ref = mask_seat(jnp.asarray(cards), jnp.asarray(size), jnp.asarray(info), jnp.int32(a))
        np.testing.assert_array_equal(got[:, a].numpy(), np.asarray(ref), err_msg=f"seat {a}")
    assert got.any() and not got.all()


def test_action_stream_and_pack_match_jax():
    n = 11
    rs = np.random.RandomState(9)
    w = rs.randint(-2**31, 2**31, size=n).astype(np.int32)
    mask = rs.rand(n, 20) < 0.3
    mask[0] = False  # no legal move: uid 0
    j_w, j_uid = jk.action_from_mask(jnp.asarray(w), jnp.asarray(mask))
    t_w, t_uid = tk.action_from_mask(torch.from_numpy(w), torch.from_numpy(mask))
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    np.testing.assert_array_equal(t_uid.numpy(), np.asarray(j_uid))
    assert all(mask[i, t_uid[i]] for i in range(1, n))
    np.testing.assert_array_equal(tk.init_action_rng(n, seed=3, device=CPU).numpy(),
                                  np.asarray(jk.init_action_rng(n, seed=3)))
    env = th.Env(**th.CONFIGS["small"])
    bstate, _ = t_reset(env, n, 6, device=CPU)
    ts = tk.pack_state(env, bstate.env_states)
    init, cnt = tk.init_packed(env, n, 6, device=CPU)
    assert int(cnt) == 6 + n and torch.equal(ts.st, init.st)
    back = tk.unpack_state(env, ts)
    for f in bstate.env_states.__dataclass_fields__:
        assert torch.equal(getattr(back, f), getattr(bstate.env_states, f)), f
    d, j_cnt = _j_init_packed(jh.Env(**jh.CONFIGS["small"]), n, 6)
    _assert_packed(env, ts, d, "init_packed")
    assert int(j_cnt) == int(cnt)


def test_wrappers_check_their_inputs():
    env = th.Env(**th.CONFIGS["very_small"])
    n = 4
    ts, cnt = tk.init_packed(env, n, device=CPU)
    acts = torch.zeros((n, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        tk.fused_step(env, tk.TState(ts.st[:-1].contiguous(), ts.obs, ts.own, ts.mask), cnt, acts)
    with pytest.raises(TypeError):
        tk.fused_step(env, tk.TState(ts.st, ts.obs.to(torch.int32), ts.own, ts.mask), cnt, acts)
    with pytest.raises(ValueError, match="contiguous"):
        tk.fused_step(env, tk.TState(ts.st.t().contiguous().t(), ts.obs, ts.own, ts.mask),
                      cnt, acts)
    with pytest.raises(ValueError):
        tk.fused_rollout(env, ts, cnt, tk.init_action_rng(n, device=CPU), 0)
    cards, size, info = tk.hand_inputs(env, ts)
    with pytest.raises(TypeError):
        tk.legal_moves(env, cards.long(), size, info)
    four = th.Env(**MASK_CONFIGS["full_4p"])
    ts4, _ = tk.init_packed(four, n, device=CPU)
    assert tk.legal_moves(four, *tk.hand_inputs(four, ts4)).shape == (n, 4, 38)
    # K11's config takes every game JAX's Env builds with a player and a
    # rank; K3's and K4's (_cfg) still only the 2-player ones
    built = 0
    for P, C, R in itertools.product(range(1, 9), range(8), range(1, 8)):
        try:
            je = jh.Env(colors=C, ranks=R, players=P)
        except (AssertionError, OverflowError):
            continue
        te = th.Env(colors=C, ranks=R, players=P)
        cfg, ints = tk._mask_cfg(te)
        assert list(cfg)[:ints] == [P, je.hand, C, R, je.num_actions, je.max_info]
        if P != 2:
            with pytest.raises(ValueError, match="2-player"):
                tk._cfg(te)
        built += 1
    assert built > 300
    for bad in (dict(ranks=0), dict(players=0)):
        with pytest.raises(ValueError, match="one player and one rank"):
            tk._mask_cfg(th.Env(**bad))
    assert tk.fused_supported(env) and not tk.fused_supported(th.Env(**THREE_PLAYERS))


@pytest.mark.parametrize("config", ["full", "small", "very_small"])
def test_seat_sums_plain_equal_the_encodes_byte_sums(config):
    """K4's closed-form seat sums (``seat_sums_plain``, which the kernel
    mirrors) equal the byte sums of a fresh obs, own-hand and mask encode of
    each seat, exactly, on the states of 300 plain legal-move steps: the
    refreshed seats' buffers hold those encodes, and the run passes through
    empty-deck shifts, reveals and fresh deals (half the envs never play
    while another move is legal, so that their games last until the deck
    runs out).  Every state lies inside K4's envelope."""
    env = th.Env(**th.CONFIGS[config])
    n = 160
    ts, cnt = tk.init_packed(env, n, device=CPU)
    w = tk.init_action_rng(n, seed=1, device=CPU)[0]
    scal = tk.row_offsets(env)["scal"]
    ds, lmm = scal + tk.SCAL_FIELDS.index("deck_size"), scal + tk.SCAL_FIELDS.index("lm_move")
    seen = dict(shifts=0, reveals=0, deals=0)
    plays = torch.zeros(env.num_actions, dtype=torch.bool)
    plays[env.hand:2 * env.hand] = True
    careful = torch.arange(n)[:, None] >= n // 2
    for t in range(300):
        mask = tk.active_mask(env, ts)
        no_play = mask & ~plays
        mask = torch.where(careful & no_play.any(1, keepdim=True), no_play, mask)
        w, uid = tk.action_from_mask(w, mask)
        empty = ts.st[ds] == 0
        ts, _, done, cnt = tk.fused_step_plain(env, ts, cnt, uid[:, None].expand(n, 2).contiguous())
        s = tk.unpack_state(env, ts)
        fresh = []
        for a in range(env.players):
            obs, own = env._encode_seat(s, a)
            mask = env.legal_mask(s.hand_cards, s.hand_size, s.info_tokens, a)
            fresh.append(obs.sum(1, dtype=torch.int32) + own.sum(1, dtype=torch.int32)
                         + mask.sum(1, dtype=torch.int32))
        fresh = torch.stack(fresh, 1)
        sums = tk.seat_sums_plain(env, ts)
        assert torch.equal(sums, fresh), t
        bufs = (ts.obs.sum(2, dtype=torch.int32) + ts.own.sum(2, dtype=torch.int32)
                + ts.mask.sum(2, dtype=torch.int32))
        refreshed = done[:, None] | (torch.arange(2)[None, :] == ts.st[scal + tk.CUR][:, None])
        assert torch.equal(bufs[refreshed], sums[refreshed]), t
        assert not tk.envelope_violations(env, ts.st), t
        seen["shifts"] += int((empty & (uid < 2 * env.hand) & ~done).sum())
        seen["reveals"] += int(((ts.st[lmm] >= th.M_REVEAL_C) & ~done).sum())
        seen["deals"] += int(done.sum())
    assert min(seen.values()) > 0, seen


def _jax_encodes(env_j):
    """JAX's encodes of every seat of a batch (``_encode_seat``, ``_mask_seat``)
    of the port's plain state ``s``: (obs [N, P, OBS], own [N, P, H*C*R],
    mask [N, P, A]) as numpy arrays."""
    seats = jnp.arange(env_j.players)

    def one(s1):
        obs, own = jax.vmap(lambda a: env_j._encode_seat(s1, a))(seats)
        return obs, own, jax.vmap(lambda a: env_j._mask_seat(s1, a))(seats)

    run = jax.jit(jax.vmap(one))

    def encodes(s):
        fields = {}
        for f in jh.State.__dataclass_fields__:
            x = getattr(s, f).numpy()
            fields[f] = jnp.asarray(x.astype(np.uint32) if f in ("hand_plausible", "rng_v") else x)
        return tuple(np.asarray(x) for x in run(jh.State(**fields)))

    return encodes


@pytest.mark.parametrize("config", ["full", "small", "very_small"])
def test_encode_table_writes_the_jax_encodes(config):
    """K3's section table and seat values (``encode_table``,
    ``seat_values_plain``; the kernel writes a refreshed seat's bytes from
    them) give every seat's obs, own-hand and mask bytes exactly as JAX's
    ``_encode_seat`` and ``_mask_seat`` do, on the states of 150 plain
    legal-move steps through empty-deck shifts, reveals and fresh deals (half
    the envs never play while another move is legal)."""
    env, env_j = th.Env(**th.CONFIGS[config]), jh.Env(**jh.CONFIGS[config])
    encodes = _jax_encodes(env_j)
    n = 64
    ts, cnt = tk.init_packed(env, n, device=CPU)
    w = tk.init_action_rng(n, seed=2, device=CPU)[0]
    scal = tk.row_offsets(env)["scal"]
    ds, lmm = scal + tk.SCAL_FIELDS.index("deck_size"), scal + tk.SCAL_FIELDS.index("lm_move")
    seen = dict(shifts=0, reveals=0, deals=0)
    plays = torch.zeros(env.num_actions, dtype=torch.bool)
    plays[env.hand:2 * env.hand] = True
    careful = torch.arange(n)[:, None] >= n // 2
    for t in range(150):
        mask = tk.active_mask(env, ts)
        no_play = mask & ~plays
        mask = torch.where(careful & no_play.any(1, keepdim=True), no_play, mask)
        w, uid = tk.action_from_mask(w, mask)
        empty = ts.st[ds] == 0
        ts, _, done, cnt = tk.fused_step_plain(env, ts, cnt, uid[:, None].expand(n, 2).contiguous())
        obs, own, msk = tk.encodes_plain(env, ts)
        j_obs, j_own, j_mask = encodes(tk.unpack_state(env, ts))
        np.testing.assert_array_equal(obs.numpy(), j_obs.astype(np.int8), err_msg=f"t={t} obs")
        np.testing.assert_array_equal(own.numpy(), j_own.astype(np.int8), err_msg=f"t={t} own")
        np.testing.assert_array_equal(msk.numpy(), j_mask.astype(bool), err_msg=f"t={t} mask")
        seen["shifts"] += int((empty & (uid < 2 * env.hand) & ~done).sum())
        seen["reveals"] += int(((ts.st[lmm] >= th.M_REVEAL_C) & ~done).sum())
        seen["deals"] += int(done.sum())
    assert min(seen.values()) > 0, seen


def test_encode_table_layout():
    """The section table's shape: one entry per obs, own-hand and mask byte,
    each reading a value inside ``value_layout`` (3H + 3PH + C + CR + A + 14
    values) with a constant the clamp to [-1, 64] keeps; full has 109 values
    and 803 entries.  The kernels' ``Cfg`` carries the layout's group
    starts and count after the 21 ints of sizes and row offsets."""
    for config in ("full", "small", "very_small"):
        env = th.Env(**th.CONFIGS[config])
        C, R, P, H, A = env.colors, env.ranks, env.players, env.hand, env.num_actions
        count = tk.value_layout(env)["count"]
        assert count == 3 * H + 3 * P * H + C + C * R + A + 14
        tab = tk.encode_table(env).to(torch.int64)
        assert tab.shape == (env.obs_size + H * env.bits_per_card + A,)
        idx, lo, span = tab & 0xFF, (tab >> 8) & 0xFF, tab >> 16
        assert int(idx.max()) < count and int(lo.max()) <= 64
        assert set(span.tolist()) == {0, 127}
        vals = tk.seat_values_plain(env, tk.init_packed(env, 3, device=CPU)[0])
        assert vals.shape == (3, P, count) and vals.dtype == torch.int8
        cfg, n = tk._cfg(env)
        assert n == 44 and list(cfg)[21:] == list(tk.value_layout(env).values())
    assert tk.value_layout(th.Env(**th.CONFIGS["full"]))["count"] == 109


def test_rollout_envelope_names_the_rows_outside_it():
    """The rows K4's carry holds in bytes are checked against their ranges;
    a state outside is named row by row (the CUDA wrapper refuses it), and
    the last-move rows, rewritten by every step before K4 reads them, and
    the 32-bit rows take any int32."""
    env = th.Env(**th.CONFIGS["full"])
    ts, _ = tk.init_packed(env, 5, device=CPU)
    off = tk.row_offsets(env)
    assert tk.envelope_violations(env, ts.st) == []
    st = ts.st.clone()
    st[off["scal"] + tk.SCAL_FIELDS.index("lm_color"), 1] = 1000
    st[off["hp"] + 3, 2] = -7
    st[off["scal"] + tk.SCAL_FIELDS.index("rng_v"), 0] = -2**31
    assert tk.envelope_violations(env, st) == []
    st[off["deck"] + 4, 3] = 25
    st[off["scal"] + tk.SCAL_FIELDS.index("turns_to_play"), 0] = 3
    st[off["kr"] + 9, 4] = -2
    bad = tk.envelope_violations(env, st)
    assert [b.split(":")[0] for b in bad] == ["deck[4]", "turns_to_play", "kr[9]"]
    assert bad[0].endswith("..25") and bad[1:] == ["turns_to_play: 2..3", "kr[9]: -2..-1"]


def test_collector_matches_batched_step():
    """The collector's StepOutput (state_obs = obs ++ own, the int32 reward
    delta broadcast to both seats as float32, active = the seat to act)
    equals the plain batched_step's, and pack/unpack round-trips the
    BatchState."""
    n = 8
    env = th.Env(**th.CONFIGS["small"])
    fc = make_fused_collect(env, n, device=CPU)
    bstate, out = t_reset(env, n, device=CPU)
    carry = fc.pack(bstate)
    rs = np.random.RandomState(7)
    for t in range(40):
        acts = torch.from_numpy(legal_actions(rs, out.action_mask.numpy()))
        bstate, out = t_step(env, bstate, acts)
        carry, fout = fc.step(carry, acts)
        for f in OUT_FIELDS:
            got, ref = getattr(fout, f), getattr(out, f)
            assert got.dtype == ref.dtype and torch.equal(got, ref), (t, f)
    back = fc.unpack(carry)
    assert int(back.episode_counter) == int(bstate.episode_counter) > n
    for f in bstate.env_states.__dataclass_fields__:
        assert torch.equal(getattr(back.env_states, f), getattr(bstate.env_states, f)), f
    assert not make_fused_collect(th.Env(**THREE_PLAYERS), n, device=CPU).kernel


@pytest.mark.parametrize("players", [2, 3, 4, 5])
def test_env_refuses_exactly_the_configs_jax_refuses(players):
    """Colours and ranks 1..7: either both constructors raise the same
    exception type, or both build games of the same sizes.  Both raise on
    C * R > 32 cards (OverflowError: the uint32 plausible mask) and on more
    than NUM_MOVES_MAX moves (AssertionError: 7 x 7 with 5 players)."""
    refused = 0
    for colors, ranks in itertools.product(range(1, 8), repeat=2):
        cfg = dict(colors=colors, ranks=ranks, players=players)
        got = {}
        for side, make in (("jax", jh.Env), ("port", th.Env)):
            try:
                env = make(**cfg)
            except Exception as e:  # noqa: BLE001 - the type is compared
                got[side] = type(e)
            else:
                got[side] = (env.obs_size, env.state_size, env.num_actions, env.max_cards)
        assert got["jax"] == got["port"], (cfg, got)
        refused += isinstance(got["port"], type)
        if colors * ranks > 32:
            assert got["port"] in (OverflowError, AssertionError), cfg
    # (5,7), (6,6), (6,7), (7,5), (7,6), (7,7) for every player count
    assert refused == 6


def test_rollout_plain_chained_matches_jax():
    """A second rollout from the first one's output, whose obs / own / mask
    are the launch-time buffers: K4's plain version draws the acting seat's
    move from the state, as JAX's kernel (and K4) do, not from the stale
    mask buffer."""
    env_j, env_t = jh.Env(**jh.CONFIGS["small"]), th.Env(**th.CONFIGS["small"])
    n, T = 8, 12
    ts, cnt = tk.init_packed(env_t, n, device=CPU)
    w = tk.init_action_rng(n, seed=5, device=CPU)
    d, j_cnt = _j_init_packed(env_j, n)
    j_w = jk.init_action_rng(n, seed=5)
    run = jax.jit(lambda d_, c_, w_: jk.fused_rollout(env_j, d_, c_, w_, T, block=n,
                                                      interpret=True))
    for call in range(2):
        d, j_cnt, j_w, j_dcnt, j_chk = run(d, j_cnt, j_w)
        ts, w, cnt, t_dcnt, t_chk = tk.fused_rollout(env_t, ts, cnt, w, T)
        _assert_packed(env_t, ts, d, f"call {call}")
        np.testing.assert_array_equal(w.numpy(), np.asarray(j_w))
        np.testing.assert_array_equal(t_dcnt.numpy(), np.asarray(j_dcnt))
        np.testing.assert_array_equal(t_chk.numpy(), np.asarray(j_chk))
        assert int(cnt) == int(j_cnt)


def test_rollout_kernel_is_chosen_on_the_card():
    """K4's two kernels (records in shared memory, or in device memory) are
    chosen by N in ``hk_rollout`` on the card, which ``rollout_kernel``
    asks; the CPU has no such choice, and asking for it there is refused."""
    with pytest.raises(ValueError, match="CUDA"):
        tk.rollout_kernel(th.Env(**th.CONFIGS["full"]), 1024, "cpu")
