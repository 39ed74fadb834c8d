"""The plain versions of the port's Overcooked kernels against the JAX kernels.

The JAX side runs ``fused_step``/``fused_rollout`` in Pallas interpret mode
on the CPU, as ``tests/test_overcooked_pallas.py`` does.  The kernels
themselves run only on the card, where ``chip_smoke.py`` holds each against
these plain versions.  Every comparison is exact.  The last tests hold the
layout the kernels read (built once per env) against the plain env.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.envs import overcooked as j_oc
from madrona_rl_envs_playground_tpu.envs import overcooked2 as j_oc2
from madrona_rl_envs_playground_tpu.ops import overcooked_pallas as jok
from madrona_rl_envs_playground_tpu_torch.envs import overcooked as t_oc
from madrona_rl_envs_playground_tpu_torch.envs import overcooked2 as t_oc2
from madrona_rl_envs_playground_tpu_torch.ops import overcooked as tok

CPU = torch.device("cpu")
JAX_FIELDS = ("obj_name", "obj_onions", "obj_tomatoes", "obj_tick", "pos",
              "orient", "held_name", "held_onions", "held_tomatoes", "held_tick")


def _make(variant, layout, horizon, num_players=None):
    jm, tm = (j_oc, t_oc) if variant == "v1" else (j_oc2, t_oc2)
    return (jm.make(layout, horizon=horizon, num_players=num_players),
            tm.make(layout, horizon=horizon, num_players=num_players))


def _assert_tstate_equal(t_ts, j_ts, msg):
    """The port's rows are the JAX TState fields stacked in order."""
    ref_rows = np.concatenate([np.asarray(getattr(j_ts, f)) for f in JAX_FIELDS])
    np.testing.assert_array_equal(t_ts.rows.numpy(), ref_rows, err_msg=f"{msg} rows")
    np.testing.assert_array_equal(t_ts.timestep.numpy(), np.asarray(j_ts.timestep)[0],
                                  err_msg=f"{msg} timestep")


def _obs_from_jax_layout(env, obs_pcsn):
    """obs[n, p, (x*H + y)*C + c] = obs_jax[p, c, y*W + x, n] (ops/overcooked.py)."""
    P, C, H, W = env.num_players, env.num_channels, env.height, env.width
    N = obs_pcsn.shape[-1]
    o = np.asarray(obs_pcsn).reshape(P, C, H, W, N)
    return o.transpose(4, 0, 3, 2, 1).reshape(N, P, W * H * C)


@pytest.mark.parametrize("variant,layout,horizon,steps,seed,players", [
    ("v1", "cramped_room", 8, 14, 5, None),
    ("v2", "simple", 8, 14, 3, None),
    ("v1", "multiplayer_schelling", 6, 8, 7, None),
    # the kernels' other check layouts: P = 1, the largest grid, P = 3
    ("v1", "simple_single", 8, 10, 11, None),
    ("v1", "small_corridor", 6, 8, 13, None),
    ("v1", "multiplayer_schelling", 6, 8, 17, 3),
])
def test_step_plain_matches_jax_fused_step(variant, layout, horizon, steps, seed, players):
    n = 8
    j_env, t_env = _make(variant, layout, horizon, players)
    j_ts = jok.init_packed(j_env, n)
    t_ts = tok.init_packed(t_env, n, device=CPU)
    _assert_tstate_equal(t_ts, j_ts, "init")
    j_step = jax.jit(lambda ts, a: jok.fused_step(j_env, ts, a, block=n, interpret=True))
    rs = np.random.RandomState(seed)
    P = j_env.num_players
    for t in range(steps):
        acts = rs.choice(6, size=(P, n), p=[.15, .15, .15, .15, .05, .35]).astype(np.int32)
        j_ts, j_obs, j_rew, j_done = j_step(j_ts, jnp.asarray(acts))
        t_ts, t_obs, t_rew, t_done = tok.fused_step(t_env, t_ts, torch.from_numpy(acts))
        np.testing.assert_array_equal(t_obs.numpy(), _obs_from_jax_layout(j_env, j_obs),
                                      err_msg=f"t={t} obs")
        np.testing.assert_array_equal(t_rew.numpy(), np.asarray(j_rew), err_msg=f"t={t} reward")
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done), err_msg=f"t={t} done")
        _assert_tstate_equal(t_ts, j_ts, f"t={t}")


def test_pack_unpack_roundtrip_and_init_packed():
    from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset

    env = t_oc.make("cramped_room", horizon=5)
    bstate, _ = batched_reset(env, 6, device=CPU)
    ts = tok.pack_state(env, bstate.env_states)
    init = tok.init_packed(env, 6, device=CPU)
    assert torch.equal(ts.rows, init.rows) and torch.equal(ts.timestep, init.timestep)
    back = tok.unpack_state(env, ts)
    for f in JAX_FIELDS + ("timestep",):
        assert torch.equal(getattr(back, f), getattr(bstate.env_states, f)), f


@pytest.mark.parametrize("variant,layout", [("v1", "cramped_room"), ("v2", "simple")])
def test_rollout_plain_matches_jax_fused_rollout(variant, layout):
    n, block, T = 8, 4, 70
    j_env, t_env = _make(variant, layout, 30)
    P = j_env.num_players
    j_ts = jok.init_packed(j_env, n)
    j_w = jok.init_action_rng(n, P, seed=0)
    j_ts2, j_w2, j_dcnt, j_chk = jax.jit(
        lambda ts, w: jok.fused_rollout(j_env, ts, w, T, block=block, interpret=True)
    )(j_ts, j_w)
    t_ts = tok.init_packed(t_env, n, device=CPU)
    t_w = tok.init_action_rng(n, P, seed=0, device=CPU)
    t_ts2, t_w2, t_dcnt, t_chk = tok.fused_rollout(t_env, t_ts, t_w, T)
    np.testing.assert_array_equal(t_w2.numpy(), np.asarray(j_w2))
    np.testing.assert_array_equal(t_dcnt.numpy(), np.asarray(j_dcnt))
    np.testing.assert_array_equal(t_chk.numpy(), np.asarray(j_chk))
    assert t_chk.dtype == torch.int32 and t_dcnt.dtype == torch.int32
    _assert_tstate_equal(t_ts2, j_ts2, "final")


def test_wrappers_check_their_inputs():
    env = t_oc.make("cramped_room", horizon=5)
    ts = tok.init_packed(env, 4, device=CPU)
    with pytest.raises(ValueError):
        tok.fused_step(env, tok.TState(ts.rows[:-1], ts.timestep),
                       torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(TypeError):
        tok.fused_step(env, tok.TState(ts.rows.int(), ts.timestep),
                       torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        tok.fused_rollout(env, ts, tok.init_action_rng(4, 2, device=CPU), 0)
    big = t_oc.make("many_player_layout", horizon=5, num_players=6)
    with pytest.raises(ValueError):
        tok.init_packed(big, 4, device=CPU)


# ---- the kernels' layout, built once per env ----------------------------------

LAYOUT_CASES = [("v1", "cramped_room"), ("v2", "simple"), ("v1", "simple_single"),
                ("v1", "multiplayer_schelling")]


def _t_env(variant, layout, horizon=400):
    return (t_oc if variant == "v1" else t_oc2).make(layout, horizon=horizon)


def _fields(lay):
    return {name: (list(getattr(lay, name)) if hasattr(getattr(lay, name), "__len__")
                   else getattr(lay, name)) for name, _ in tok._Layout._fields_}


@pytest.mark.parametrize("variant,layout", LAYOUT_CASES)
def test_layout_is_cached_and_equals_a_fresh_one(variant, layout):
    env = _t_env(variant, layout)
    cached = tok._layout(env)
    assert tok._layout(env) is cached
    assert _fields(cached) == _fields(tok._make_layout(env))
    assert bytes(tok._device_layout(env, CPU).numpy()) == bytes(cached)
    assert tok._device_layout(env, CPU) is tok._device_layout(env, CPU)
    terr = list(env.terrain)
    assert list(cached.pots[:cached.n_pots]) == [s for s, t in enumerate(terr) if t == 1]
    assert list(cached.counters[:cached.n_counters]) == [s for s, t in enumerate(terr) if t == 2]


def test_layouts_of_two_envs_are_not_shared():
    a, b = _t_env("v1", "cramped_room"), _t_env("v1", "cramped_room", horizon=9)
    c = _t_env("v2", "simple")
    assert tok._layout(a) is not tok._layout(b) and tok._layout(a) is not tok._layout(c)
    assert (tok._layout(a).horizon, tok._layout(b).horizon) == (400, 9)
    assert tok._layout(c).v1 == 0 and tok._layout(a).v1 == 1


@pytest.mark.parametrize("variant,layout", LAYOUT_CASES)
def test_cell_order_decodes_the_plain_obs(variant, layout):
    """K1 decodes each obs record (env, observer, obs cell q) through the
    layout's ``cell_of`` table into a state cell: from the plain env's state
    that gives the plain env's player block and terrain channels exactly;
    ``base_total`` is the terrain one-hots' sum over every observer's obs."""
    from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset, batched_step

    env = _t_env(variant, layout)
    N, P, S, C = 16, env.num_players, env.size, env.num_channels
    lay = tok._layout(env)
    cell_of = torch.tensor(list(lay.cell_of[:S]), dtype=torch.int64)
    terr = torch.tensor(env.terrain)[cell_of]                       # [S] by obs cell
    bstate, out = batched_reset(env, N, device=CPU)
    # at the start the object block holds only the terrain one-hots
    obj0 = out.obs.reshape(N, P, S, C)[..., 5 * P:].to(torch.int64)
    assert int(obj0.sum()) == N * lay.base_total
    rs = np.random.RandomState(5)
    for _ in range(12):
        acts = torch.from_numpy(rs.randint(0, 6, size=(N, P)).astype(np.int32))
        bstate, out = batched_step(env, bstate, acts)
        st = bstate.env_states
        obs = out.obs.reshape(N, P, S, C).to(torch.int64)
        for i in range(P):
            for r in range(P):
                j = i if r == 0 else (r - 1 if r <= i else r)  # rank r of observer i
                here = cell_of[None, :] == st.pos[:, j:j + 1]             # [N, S]
                assert torch.equal(obs[:, i, :, r], here.long())
                for d in range(4):
                    want = here & (st.orient[:, j:j + 1] == d)
                    assert torch.equal(obs[:, i, :, P + 4 * r + d], want.long())
            # channels 5P..5P+4 hold only terrain one-hots in both variants
            for k in range(5):
                assert torch.equal(obs[:, i, :, 5 * P + k],
                                   (terr == k + 1).long().expand(N, S))
