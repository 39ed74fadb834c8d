"""The port's Balance Beam env, K7/K8 plain versions, collector and trainer
against the JAX package.

Inputs come from numpy seeds; both sides run on the CPU; the JAX kernels run
in Pallas interpret mode, as ``tests/test_balance_pallas.py`` runs them.
The env is integer arithmetic apart from the reward, which both sides
compute in the same float32 operation order, so every comparison of the env
and the kernels' plain versions is exact.  The trainer's log-probs and
values are compared at ``atol 1e-5`` (float32 matrix products summed in
other orders), as ``tests/test_torch_train.py`` compares them.  The CUDA
kernels run only on the card, where ``chip_smoke.py`` holds them against
these plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.core.batch import batched_reset as j_reset
from madrona_rl_envs_playground_tpu.core.batch import batched_step as j_step
from madrona_rl_envs_playground_tpu.envs import balance_beam as jb
from madrona_rl_envs_playground_tpu.ops import balance_pallas as jbp
from madrona_rl_envs_playground_tpu.train import selfplay as j_selfplay
from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset as t_reset
from madrona_rl_envs_playground_tpu_torch.core.batch import batched_step as t_step
from madrona_rl_envs_playground_tpu_torch.envs import balance_beam as tb
from madrona_rl_envs_playground_tpu_torch.models.cleanrl import load_flax_params
from madrona_rl_envs_playground_tpu_torch.ops import balance as tbp
from madrona_rl_envs_playground_tpu_torch.train import selfplay as t_selfplay
from madrona_rl_envs_playground_tpu_torch.train.fused_collect import make_fused_collect

from .test_torch_train import _np_params, assert_update_matches_jax, jax_rollout_injected

CPU = torch.device("cpu")
FIELDS = ("loc", "obs", "time")


def _assert_state(t_state, j_state, msg):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t_state, f).numpy(),
                                      np.asarray(getattr(j_state, f)), err_msg=f"{msg} {f}")
    np.testing.assert_array_equal(t_state.rng_v.numpy(),
                                  np.asarray(j_state.rng_v).astype(np.int64),
                                  err_msg=f"{msg} rng_v")


@pytest.mark.parametrize("n,steps,start,seed", [(64, 40, 3, 0), (19, 30, 2**32 - 30, 2)])
def test_plain_env_matches_jax_batched_step(n, steps, start, seed):
    """Every output and the state, exactly; the second case wraps the
    uint32 episode counter."""
    je, te = jb.Env(), tb.Env()
    j_bs, j_out = j_reset(je, n, start)
    t_bs, t_out = t_reset(te, n, start, device=CPU)
    np.testing.assert_array_equal(t_out.obs.numpy(), np.asarray(j_out.obs))
    step = jax.jit(j_step, static_argnums=(0,))
    rs = np.random.RandomState(seed)
    rewards = set()
    for t in range(steps):
        acts = rs.randint(0, 4, size=(n, 2)).astype(np.int32)
        j_bs, j_out = step(je, j_bs, jnp.asarray(acts))
        t_bs, t_out = t_step(te, t_bs, torch.from_numpy(acts))
        for f in ("obs", "state_obs", "action_mask", "active", "reward", "done"):
            got, ref = getattr(t_out, f).numpy(), np.asarray(getattr(j_out, f))
            assert got.dtype == ref.dtype and got.shape == ref.shape, (f, got.dtype, ref.dtype)
            np.testing.assert_array_equal(got, ref, err_msg=f"t={t} {f}")
        _assert_state(t_bs.env_states, j_bs.env_states, f"t={t}")
        assert int(t_bs.episode_counter) == int(j_bs.episode_counter), t
        rewards.update(t_out.reward[:, 0].tolist())
    # colocation, distance and fall-off rewards all occur
    assert 1.0 in rewards and any(r < -1.0 for r in rewards), rewards


def _j_packed(ts: tbp.TState):
    """The port's layout -> the JAX kernel's seat-major rows."""
    n = ts.rng.shape[0]
    return (jnp.asarray(ts.loc.numpy().T), jnp.asarray(ts.obs.numpy().reshape(n, 14).T),
            jnp.asarray(ts.time.numpy()[None, :]), jnp.asarray(ts.rng.numpy()[None, :]))


def _assert_packed(t_ts, j_loc, j_obs, j_time, j_rng, msg):
    n = t_ts.rng.shape[0]
    np.testing.assert_array_equal(t_ts.loc.numpy(), np.asarray(j_loc).T, err_msg=f"{msg} loc")
    np.testing.assert_array_equal(t_ts.obs.numpy().reshape(n, 14), np.asarray(j_obs).T,
                                  err_msg=f"{msg} obs")
    np.testing.assert_array_equal(t_ts.time.numpy(), np.asarray(j_time)[0], err_msg=f"{msg} time")
    np.testing.assert_array_equal(t_ts.rng.numpy(), np.asarray(j_rng)[0], err_msg=f"{msg} rng")


def _edge_state(ts: tbp.TState, every: bool) -> tbp.TState:
    """Both players mid-beam, where a move of 1 or 2 either way stays on
    it, with 1 step left (every episode ends in the next step) or 3 (none
    does); chip_smoke.py's edge_state."""
    return dataclasses.replace(ts, loc=torch.full_like(ts.loc, 2),
                               time=torch.full_like(ts.time, 1 if every else 3))


# counter starts, then the two states the card's check also steps from:
# every world resetting in one step, and none
@pytest.mark.parametrize("start", [0, 2**32 - 64 - 100, "every_world_resets",
                                   "no_world_resets"])
def test_step_plain_matches_jax_fused_step(start):
    """K7's plain version against the JAX kernel on a 4-block grid (block
    16 of N = 64), so the SMEM counter carry between blocks is exercised.
    In the second case the counter starts 100 short of 2^32 and wraps
    during the run; the last two take one step from ``_edge_state``."""
    n = 64
    edge = isinstance(start, str)
    t_ts, t_cnt = tbp.init_packed(n, 0 if edge else start, device=CPU)
    if edge:
        t_ts = _edge_state(t_ts, start == "every_world_resets")
    cnt0 = int(t_cnt)
    j_st = _j_packed(t_ts)
    j_cnt = jnp.asarray(np.uint32(int(t_cnt)).view(np.int32))
    j_step_k = jax.jit(lambda l, o, ti, r, c, a: jbp.fused_step(l, o, ti, r, c, a, block=16,
                                                                interpret=True))
    rs = np.random.RandomState(5)
    resets = 0
    for t in range(1 if edge else 30):
        acts = rs.randint(0, 4, size=(n, 2)).astype(np.int32)
        *j_st, j_rew, j_done, j_cnt = j_step_k(*j_st, j_cnt, jnp.asarray(acts.T))
        t_ts, t_rew, t_done, t_cnt = tbp.fused_step(t_ts, t_cnt, torch.from_numpy(acts))
        np.testing.assert_array_equal(t_rew.numpy(), np.asarray(j_rew), err_msg=f"t={t} reward")
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done), err_msg=f"t={t} done")
        assert int(t_cnt) == int(np.asarray(j_cnt).view(np.uint32)), t
        _assert_packed(t_ts, *j_st, f"t={t}")
        resets += int(t_done.sum())
    if edge:
        assert resets == (n if start == "every_world_resets" else 0)
        return
    assert resets > 3 * n
    assert (int(t_cnt) < cnt0) == (start > 0)


def test_rollout_plain_matches_jax_fused_rollout_one_block():
    """K8's plain version allocates per step in world order, which is JAX's
    fused_rollout with one block (block == N); every output exactly."""
    n, T = 64, 50
    t_ts, t_cnt = tbp.init_packed(n, device=CPU)
    t_w = tbp.init_action_rng(n, seed=1, device=CPU)
    *j_st, j_cnt = jbp.init_packed(n)
    j_w = jbp.init_action_rng(n, seed=1)
    _assert_packed(t_ts, *j_st, "init")
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    out = jax.jit(lambda l, o, ti, r, c, w: jbp.fused_rollout(l, o, ti, r, c, w, T, block=n,
                                                              interpret=True))(*j_st, j_cnt, j_w)
    j_loc, j_obs, j_time, j_rng, j_w, j_cnt, j_dcnt, j_chk = out
    t_ts, t_w, t_cnt, t_dcnt, t_chk = tbp.fused_rollout(t_ts, t_cnt, t_w, T)
    _assert_packed(t_ts, j_loc, j_obs, j_time, j_rng, "final")
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    np.testing.assert_array_equal(t_dcnt.numpy(), np.asarray(j_dcnt))
    np.testing.assert_array_equal(t_chk.numpy(), np.asarray(j_chk))
    assert int(t_cnt) == int(j_cnt)
    assert t_dcnt.dtype == torch.int32 and t_chk.dtype == torch.float32
    assert int(t_dcnt.min()) >= T // 3


def test_pack_unpack_and_action_stream_match_jax():
    n = 11
    bstate, _ = t_reset(tb.Env(), n, 6, device=CPU)
    ts = tbp.pack_state(bstate.env_states)
    init, cnt = tbp.init_packed(n, 6, device=CPU)
    for f in ("loc", "obs", "time", "rng"):
        assert torch.equal(getattr(ts, f), getattr(init, f)), f
    assert int(cnt) == 6 + n
    back = tbp.unpack_state(ts)
    for f in FIELDS + ("rng_v",):
        assert torch.equal(getattr(back, f), getattr(bstate.env_states, f)), f
    *j_st, _ = jbp.init_packed(n, 6)
    _assert_packed(ts, *j_st, "init_packed")
    t_w, j_w = tbp.init_action_rng(n, seed=3, device=CPU), jbp.init_action_rng(n, seed=3)
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    for _ in range(5):
        t_w, t_a = tbp.action_lcg_next(t_w)
        j_w, j_a = jbp.action_lcg_next(j_w)
        np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
        np.testing.assert_array_equal(t_a.numpy(), np.asarray(j_a))


@pytest.mark.parametrize("wild", [False, True])
def test_packed_carry_round_trips_after_two_steps(wild):
    """K8's packed word (``pack_positions``) holds every world exactly from
    its third step on, and after two steps all but the t-2 history slots,
    which the third step drops (the kernel runs the first two steps at full
    width and packs before the third): over 300 plain random-action steps,
    from fresh episodes or from random int32 obs history, times and
    positions, unpacking the word and the time gives back the state's loc
    and obs."""
    n = 300
    ts, cnt = tbp.init_packed(n, device=CPU)
    rs = np.random.RandomState(5)
    if wild:
        rand = lambda *shape: torch.from_numpy(rs.randint(-2**31, 2**31 - 1, size=shape,
                                                          dtype=np.int64).astype(np.int32))
        loc = torch.where(torch.from_numpy(rs.rand(n, 2) < 0.7),
                          torch.from_numpy(rs.randint(0, 5, (n, 2)).astype(np.int32)), rand(n, 2))
        ts = tbp.TState(loc=loc, obs=rand(n, 2, 7), time=rand(n).abs(), rng=ts.rng)
    resets = 0
    for t in range(300):
        a = torch.from_numpy(rs.randint(0, 4, (n, 2)).astype(np.int32))
        ts, _, done, cnt = tbp.fused_step_plain(ts, cnt, a)
        resets += int(done.sum())
        loc, obs = tbp.unpack_positions(tbp.pack_positions(ts), ts.time)
        keep = [0, 1, 3, 4, 6] if t == 1 else list(range(7))  # t-2 slots: 2 and 5
        if t >= 1:
            assert torch.equal(loc, ts.loc) and torch.equal(obs[..., keep], ts.obs[..., keep]), t
    assert resets > n


def test_wrappers_check_their_inputs():
    n = 4
    ts, cnt = tbp.init_packed(n, device=CPU)
    acts = torch.zeros((n, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        tbp.fused_step(tbp.TState(ts.loc, ts.obs[:, :, :6].contiguous(), ts.time, ts.rng),
                       cnt, acts)
    with pytest.raises(TypeError):
        tbp.fused_step(tbp.TState(ts.loc.long(), ts.obs, ts.time, ts.rng), cnt, acts)
    with pytest.raises(ValueError, match="16-byte"):
        tbp.fused_step(tbp.TState(torch.zeros(2 * n + 1, dtype=torch.int32)[1:].view(n, 2),
                                  ts.obs, ts.time, ts.rng), cnt, acts)
    with pytest.raises(ValueError):
        tbp.fused_rollout(ts, cnt, tbp.init_action_rng(n, device=CPU), 0)


def test_collector_matches_batched_step():
    """The collector's StepOutput (reward broadcast to both seats) equals the
    plain batched_step's, and pack/unpack round-trips the BatchState."""
    n = 8
    env = tb.Env()
    fc = make_fused_collect(env, n, device=CPU)
    bstate, out = t_reset(env, n, device=CPU)
    carry = fc.pack(bstate)
    rs = np.random.RandomState(7)
    for t in range(30):
        acts = torch.from_numpy(rs.randint(0, 4, size=(n, 2)).astype(np.int32))
        bstate, out = t_step(env, bstate, acts)
        carry, fout = fc.step(carry, acts)
        for f in ("obs", "state_obs", "action_mask", "active", "reward", "done"):
            got, ref = getattr(fout, f), getattr(out, f)
            assert got.dtype == ref.dtype and torch.equal(got, ref), (t, f)
    back = fc.unpack(carry)
    assert int(back.episode_counter) == int(bstate.episode_counter) > n
    for f in FIELDS + ("rng_v",):
        assert torch.equal(getattr(back.env_states, f), getattr(bstate.env_states, f)), f


def test_selfplay_rollout_and_update_match_jax():
    """A rollout with injected actions through the collector, then one PPO
    update on the JAX trajectory, both against JAX."""
    T, n = 8, 4
    common = dict(num_steps=T, hidden=32, num_layers=1, update_epochs=2,
                  num_minibatches=2, lr=1e-3)
    jt = j_selfplay.SelfPlayPPO(
        jb.Env(), n, j_selfplay.SelfPlayConfig(rollout_backend="jnp", **common), seed=0)
    tt = t_selfplay.SelfPlayPPO(tb.Env(), n, t_selfplay.SelfPlayConfig(**common),
                                seed=0, device="cpu")
    load_flax_params(tt.net, _np_params(jt.state["params"]))
    assert tt._fused.kernel
    acts = np.random.RandomState(4).randint(0, 4, size=(T, n, 2)).astype(np.int32)
    j_bstate, j_out, j_tr = jax_rollout_injected(jt, acts)
    t_bstate, t_out, t_tr = tt._rollout(torch.from_numpy(acts))
    for k in ("obs", "action", "reward", "done"):
        np.testing.assert_array_equal(t_tr[k].numpy(), np.asarray(j_tr[k]), err_msg=k)
    assert np.asarray(j_tr["done"]).any()
    for k in ("logp", "value"):
        np.testing.assert_allclose(t_tr[k].numpy(), np.asarray(j_tr[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(t_out.obs.numpy(), np.asarray(j_out.obs))
    _assert_state(t_bstate.env_states, j_bstate.env_states, "final")
    assert int(t_bstate.episode_counter) == int(j_bstate.episode_counter)
    assert_update_matches_jax(jt, tt, j_tr, j_out)
