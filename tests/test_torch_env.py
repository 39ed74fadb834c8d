"""The port's RNG, layouts and plain Overcooked env against the JAX package.

Inputs come from numpy seeds; both sides run on the CPU.  Every comparison is
exact: the env is integer arithmetic end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.core import rng as jrng
from madrona_rl_envs_playground_tpu.core.batch import batched_reset as j_reset
from madrona_rl_envs_playground_tpu.core.batch import batched_step as j_step
from madrona_rl_envs_playground_tpu.envs import layouts as j_layouts
from madrona_rl_envs_playground_tpu.envs import overcooked as j_oc
from madrona_rl_envs_playground_tpu.envs import overcooked2 as j_oc2
from madrona_rl_envs_playground_tpu.ops import cartpole_pallas as jcp
from madrona_rl_envs_playground_tpu.ops import overcooked_pallas as jok
from madrona_rl_envs_playground_tpu_torch.core import rng as trng
from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset as t_reset
from madrona_rl_envs_playground_tpu_torch.core.batch import batched_step as t_step
from madrona_rl_envs_playground_tpu_torch.envs import layouts as t_layouts
from madrona_rl_envs_playground_tpu_torch.envs import overcooked as t_oc
from madrona_rl_envs_playground_tpu_torch.envs import overcooked2 as t_oc2
from madrona_rl_envs_playground_tpu_torch.ops import overcooked as tok

CPU = torch.device("cpu")


def _ids(n=257, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    ids[:4] = [0, 1, 2**31, 2**32 - 1]
    return ids


def test_rng_uint32_stream_matches_jax():
    ids = _ids()
    t_ids = torch.from_numpy(ids.astype(np.int64))
    j_v = jax.vmap(jrng.seed)(jnp.asarray(ids))
    t_v = trng.seed(t_ids)
    np.testing.assert_array_equal(t_v.numpy(), np.asarray(j_v).astype(np.int64))
    for _ in range(5):
        j_v2, j_u = jrng.uniform(j_v)
        t_v2, t_u = trng.uniform(t_v)
        np.testing.assert_array_equal(t_v2.numpy(), np.asarray(j_v2).astype(np.int64))
        np.testing.assert_array_equal(t_u.numpy(), np.asarray(j_u))
        j_v3, j_r = jrng.randint(j_v2, 52)
        t_v3, t_r = trng.randint(t_v2, 52)
        np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
        np.testing.assert_array_equal(
            trng.next_uint(t_v2).numpy(), np.asarray(jrng.next_uint(j_v2)).astype(np.int64))
        j_v, t_v = j_v3, t_v3
    a, c = jrng.lcg_skip_constants(7)
    assert trng.lcg_skip_constants(7) == (int(a), int(c))


def test_rng_int32_kernel_helpers_match_jax():
    ids = _ids(seed=1).view(np.int32)
    t_ids = torch.from_numpy(ids.copy())
    np.testing.assert_array_equal(
        trng._tea_seed(t_ids).numpy(), np.asarray(jcp._tea_seed(jnp.asarray(ids))))
    np.testing.assert_array_equal(
        trng._lcg_next(t_ids).numpy(), np.asarray(jcp._lcg_next(jnp.asarray(ids))))
    np.testing.assert_array_equal(
        trng._unif(t_ids).numpy(), np.asarray(jcp._unif(jnp.asarray(ids))))
    assert trng._i32(0x9E3779B9) == int(jcp._i32(0x9E3779B9))


@pytest.mark.parametrize("n,p,seed", [(8, 2, 0), (13, 4, 3)])
def test_action_rng_matches_jax(n, p, seed):
    j_w = jok.init_action_rng(n, p, seed=seed)
    t_w = tok.init_action_rng(n, p, seed=seed, device=CPU)
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    for _ in range(4):
        j_w, j_a = jok.action_lcg_next(j_w, 6)
        t_w, t_a = tok.action_lcg_next(t_w, 6)
        np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
        np.testing.assert_array_equal(t_a.numpy(), np.asarray(j_a))


def test_layouts_copy_equals_reference():
    assert t_layouts.LAYOUTS == j_layouts.LAYOUTS
    for name in ("cramped_room", "simple", "many_player_layout"):
        for variant in ("v1", "v2"):
            assert (t_layouts.get_base_layout_params(name, 50, variant=variant)
                    == j_layouts.get_base_layout_params(name, 50, variant=variant))


def _make(variant, layout, horizon, num_players=None):
    jm, tm = (j_oc, t_oc) if variant == "v1" else (j_oc2, t_oc2)
    return (jm.make(layout, horizon=horizon, num_players=num_players),
            tm.make(layout, horizon=horizon, num_players=num_players))


def _assert_state_equal(t_state, j_state, msg):
    for f in j_state.__dataclass_fields__:
        np.testing.assert_array_equal(
            getattr(t_state, f).numpy(), np.asarray(getattr(j_state, f)),
            err_msg=f"{msg} state.{f}")


@pytest.mark.parametrize("variant,layout,horizon,steps,n,seed", [
    ("v1", "cramped_room", 100, 110, 32, 5),
    ("v2", "simple", 240, 260, 64, 3),
    ("v2", "simple", 7, 24, 16, 3),
    ("v1", "multiplayer_schelling", 6, 16, 12, 7),
])
def test_plain_env_matches_jax_batched_step(variant, layout, horizon, steps, n, seed):
    j_env, t_env = _make(variant, layout, horizon)
    j_bs, j_out = j_reset(j_env, n, 3)
    t_bs, t_out = t_reset(t_env, n, 3, device=CPU)
    np.testing.assert_array_equal(t_out.obs.numpy(), np.asarray(j_out.obs))
    step = jax.jit(j_step, static_argnums=(0,))
    rs = np.random.RandomState(seed)
    P = j_env.num_players
    seen = set()
    for t in range(steps):
        # bias toward interact so pots, counters and deliveries are reached
        acts = rs.choice(6, size=(n, P), p=[.15, .15, .15, .15, .05, .35]).astype(np.int32)
        j_bs, j_out = step(j_env, j_bs, jnp.asarray(acts))
        t_bs, t_out = t_step(t_env, t_bs, torch.from_numpy(acts))
        for f in ("obs", "state_obs", "action_mask", "active", "reward", "done"):
            got, ref = getattr(t_out, f).numpy(), np.asarray(getattr(j_out, f))
            assert got.dtype == ref.dtype, (f, got.dtype, ref.dtype)
            np.testing.assert_array_equal(got, ref, err_msg=f"t={t} {f}")
        _assert_state_equal(t_bs.env_states, j_bs.env_states, f"t={t}")
        assert int(t_bs.episode_counter) == int(j_bs.episode_counter)
        seen.update(t_out.reward[:, 0].tolist())
    if horizon >= 60:
        # long episodes reach pot placements and soup pickups
        assert {3, 5} <= seen, seen


def test_many_player_layout_plain_env_matches_jax():
    """A grid outside the kernels' envelope runs through the plain env."""
    j_env, t_env = _make("v1", "many_player_layout", 5, num_players=6)
    assert not tok.fused_supported(t_env)
    n = 4
    j_bs, _ = j_reset(j_env, n)
    t_bs, _ = t_reset(t_env, n, device=CPU)
    rs = np.random.RandomState(11)
    step = jax.jit(j_step, static_argnums=(0,))
    for t in range(7):
        acts = rs.randint(0, 6, size=(n, 6)).astype(np.int32)
        j_bs, j_out = step(j_env, j_bs, jnp.asarray(acts))
        t_bs, t_out = t_step(t_env, t_bs, torch.from_numpy(acts))
        np.testing.assert_array_equal(t_out.obs.numpy(), np.asarray(j_out.obs))
        np.testing.assert_array_equal(t_out.reward.numpy(), np.asarray(j_out.reward))
        _assert_state_equal(t_bs.env_states, j_bs.env_states, f"t={t}")


def test_episode_counter_wraps_as_uint32_like_jax():
    """The counter is a uint32 that advances by sum(done) and wraps."""
    j_env, t_env = _make("v1", "cramped_room", 3)
    n, start = 5, 2**32 - 8
    j_bs, _ = j_reset(j_env, n, start)
    t_bs, _ = t_reset(t_env, n, start, device=CPU)
    assert int(t_bs.episode_counter) == int(j_bs.episode_counter) == 2**32 - 3
    step = jax.jit(j_step, static_argnums=(0,))
    rs = np.random.RandomState(2)
    for t in range(7):
        acts = rs.randint(0, 6, size=(n, 2)).astype(np.int32)
        j_bs, j_out = step(j_env, j_bs, jnp.asarray(acts))
        t_bs, t_out = t_step(t_env, t_bs, torch.from_numpy(acts))
        np.testing.assert_array_equal(t_out.obs.numpy(), np.asarray(j_out.obs))
        assert int(t_bs.episode_counter) == int(j_bs.episode_counter), t
    # two resets of all five envs (t = 2 and 5) wrap the counter past 2**32
    assert int(t_bs.episode_counter) == (2**32 - 3 + 2 * n) % 2**32
