"""The port's Acrobot env, K9/K10 plain versions, collector and trainer
against the JAX package.

Inputs come from numpy seeds; both sides run on the CPU; the JAX kernels run
in Pallas interpret mode, as ``tests/test_acrobot_pallas.py`` runs them.
Integer fields (step counts, LCG words, episode counter, done, done counts,
actions) are compared exactly, and so are the reset draws.  Float rows are
compared at ``rtol = atol = 1e-6`` where both sides step from the same state
(teacher-forced): XLA's and PyTorch's CPU sin/cos may round the last bit
differently, and one RK4 step calls them 18 times.  The double pendulum is
chaotic, so free-running trajectories are held for at most 20 steps, at
``atol = 1e-4`` (measured drift after 20 steps: under 2e-6).  Random torques
rarely lift the arm to the height, so the step counts start staggered near
the 501-step limit (``470 + n % 40``, as the JAX test does) and every world
resets inside the run.  The CUDA kernels run only on the card, where
``chip_smoke.py`` holds them against these plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.core.batch import batched_reset as j_reset
from madrona_rl_envs_playground_tpu.core.batch import batched_step as j_step
from madrona_rl_envs_playground_tpu.envs import acrobot as ja
from madrona_rl_envs_playground_tpu.ops import acrobot_pallas as jap
from madrona_rl_envs_playground_tpu.train import selfplay as j_selfplay
from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset as t_reset
from madrona_rl_envs_playground_tpu_torch.core.batch import batched_step as t_step
from madrona_rl_envs_playground_tpu_torch.core.types import BatchState
from madrona_rl_envs_playground_tpu_torch.envs import acrobot as ta
from madrona_rl_envs_playground_tpu_torch.models.cleanrl import load_flax_params
from madrona_rl_envs_playground_tpu_torch.ops import acrobot as tap
from madrona_rl_envs_playground_tpu_torch.train import selfplay as t_selfplay
from madrona_rl_envs_playground_tpu_torch.train.fused_collect import make_fused_collect

from .test_torch_train import _np_params, assert_update_matches_jax, jax_rollout_injected

CPU = torch.device("cpu")
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
FREE_TOL = dict(rtol=0, atol=1e-4)
FIELDS = ("theta1", "theta2", "omega1", "omega2")


def _stagger(n):
    return 470 + np.arange(n, dtype=np.int32) % 40


def _t_state(j_state) -> ta.State:
    f = {k: torch.from_numpy(np.array(getattr(j_state, k))) for k in FIELDS}
    return ta.State(steps=torch.from_numpy(np.array(j_state.steps, np.int32)),
                    rng_v=torch.from_numpy(np.asarray(j_state.rng_v).astype(np.int64)), **f)


def _t_counter(c) -> torch.Tensor:
    return torch.tensor(int(np.asarray(c).astype(np.uint32)), dtype=torch.int64)


def _assert_state(t_state, j_state, msg, tol=STEP_TOL):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(t_state, f).numpy(),
                                   np.asarray(getattr(j_state, f)), **tol,
                                   err_msg=f"{msg} {f}")
    np.testing.assert_array_equal(t_state.steps.numpy(), np.asarray(j_state.steps),
                                  err_msg=f"{msg} steps")
    np.testing.assert_array_equal(t_state.rng_v.numpy(),
                                  np.asarray(j_state.rng_v).astype(np.int64),
                                  err_msg=f"{msg} rng_v")


def _assert_out(t_out, j_out, t, tol):
    for f in ("obs", "state_obs", "action_mask", "active", "reward", "done"):
        got, ref = getattr(t_out, f).numpy(), np.asarray(getattr(j_out, f))
        assert got.dtype == ref.dtype and got.shape == ref.shape, (f, got.dtype, ref.dtype)
        if f in ("obs", "state_obs"):
            np.testing.assert_allclose(got, ref, **tol, err_msg=f"t={t} {f}")
        else:
            np.testing.assert_array_equal(got, ref, err_msg=f"t={t} {f}")


def _staggered_pair(n, start):
    """JAX and port batch states of fresh episodes ``start + w`` with their
    step counts staggered near the limit."""
    je = ja.Env()
    j_bs, j_out = j_reset(je, n, start)
    j_bs = j_bs.replace(env_states=j_bs.env_states.replace(steps=jnp.asarray(_stagger(n))))
    return je, j_bs, j_out


def test_reset_matches_jax_exactly():
    n, start = 37, 2**32 - 50  # indices near the top of the uint32 range
    j_bs, j_out = j_reset(ja.Env(), n, start)
    t_bs, t_out = t_reset(ta.Env(), n, start, device=CPU)
    _assert_state(t_bs.env_states, j_bs.env_states, "reset", dict(rtol=0, atol=0))
    _assert_out(t_out, j_out, -1, dict(rtol=0, atol=0))
    assert int(t_bs.episode_counter) == int(j_bs.episode_counter)


@pytest.mark.parametrize("n,start,seed", [(64, 0, 0), (37, 2**32 - 40, 1)])
def test_plain_env_matches_jax_teacher_forced(n, start, seed):
    """Each step starts both sides from the JAX state; the second case wraps
    the uint32 episode counter."""
    je, j_bs, _ = _staggered_pair(n, start)
    te = ta.Env()
    step = jax.jit(j_step, static_argnums=(0,))
    rs = np.random.RandomState(seed)
    resets = np.zeros(n, np.int64)
    for t in range(45):
        acts = rs.randint(0, 3, size=(n, 1)).astype(np.int32)
        t_in = BatchState(env_states=_t_state(j_bs.env_states),
                          episode_counter=_t_counter(j_bs.episode_counter))
        j_bs, j_out = step(je, j_bs, jnp.asarray(acts))
        t_bs, t_out = t_step(te, t_in, torch.from_numpy(acts))
        _assert_out(t_out, j_out, t, STEP_TOL)
        _assert_state(t_bs.env_states, j_bs.env_states, f"t={t}")
        assert int(t_bs.episode_counter) == int(j_bs.episode_counter), t
        resets += t_out.done.numpy()
    assert resets.min() >= 1  # every world reached the step limit and reset
    assert (int(t_bs.episode_counter) < n) == (start > 0)


def test_plain_env_matches_jax_free_running():
    """One untethered 20-step trajectory at N = 64, across the resets."""
    n = 64
    je, j_bs, _ = _staggered_pair(n, 0)
    te = ta.Env()
    t_bs = BatchState(env_states=_t_state(j_bs.env_states),
                      episode_counter=_t_counter(j_bs.episode_counter))
    step = jax.jit(j_step, static_argnums=(0,))
    rs = np.random.RandomState(3)
    for t in range(20):
        acts = rs.randint(0, 3, size=(n, 1)).astype(np.int32)
        j_bs, j_out = step(je, j_bs, jnp.asarray(acts))
        t_bs, t_out = t_step(te, t_bs, torch.from_numpy(acts))
        _assert_out(t_out, j_out, t, FREE_TOL)
        _assert_state(t_bs.env_states, j_bs.env_states, f"t={t}", FREE_TOL)
        assert int(t_bs.episode_counter) == int(j_bs.episode_counter), t
    assert int(t_bs.episode_counter) > n


def _j_packed(ts: tap.TState):
    """The port's layout -> the JAX kernel's ([4, N] f32, [1, N] i32 x 2)."""
    return (jnp.asarray(ts.st.numpy().T), jnp.asarray(ts.steps.numpy()[None, :]),
            jnp.asarray(ts.rng.numpy()[None, :]))


def _assert_packed(t_ts, j_grid, j_steps, j_rng, msg, tol=STEP_TOL):
    np.testing.assert_allclose(t_ts.st.numpy(), np.asarray(j_grid).T, **tol, err_msg=f"{msg} st")
    np.testing.assert_array_equal(t_ts.steps.numpy(), np.asarray(j_steps)[0],
                                  err_msg=f"{msg} steps")
    np.testing.assert_array_equal(t_ts.rng.numpy(), np.asarray(j_rng)[0], err_msg=f"{msg} rng")


def _staggered_packed(n, start=0):
    ts, cnt = tap.init_packed(n, start, device=CPU)
    return dataclasses.replace(ts, steps=torch.from_numpy(_stagger(n))), cnt


@pytest.mark.parametrize("start", [0, 2**32 - 64 - 30])
def test_step_plain_matches_jax_fused_step(start):
    """K9's plain version against the JAX kernel on a 4-block grid (block
    16 of N = 64), so the SMEM counter carry between blocks is exercised;
    teacher-forced.  In the second case the counter starts 30 short of 2^32
    and wraps during the run."""
    n = 64
    t_ts, t_cnt = _staggered_packed(n, start)
    cnt0 = int(t_cnt)
    j_step_k = jax.jit(lambda g, s, r, c, a: jap.fused_step(g, s, r, c, a, block=16,
                                                             interpret=True))
    rs = np.random.RandomState(5)
    resets = np.zeros(n, np.int64)
    for t in range(42):
        acts = rs.randint(0, 3, size=(n, 1)).astype(np.int32)
        j_grid, j_steps, j_rng = _j_packed(t_ts)
        j_cnt = jnp.asarray(np.uint32(int(t_cnt)).view(np.int32))
        j_grid, j_steps, j_rng, j_done, j_cnt = j_step_k(j_grid, j_steps, j_rng, j_cnt,
                                                         jnp.asarray(acts.T))
        t_ts, t_done, t_cnt = tap.fused_step(t_ts, t_cnt, torch.from_numpy(acts))
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done), err_msg=f"t={t} done")
        assert int(t_cnt) == int(np.asarray(j_cnt).view(np.uint32)), t
        _assert_packed(t_ts, j_grid, j_steps, j_rng, f"t={t}")
        t_ts = dataclasses.replace(t_ts, st=torch.from_numpy(np.array(j_grid).T.copy()))
        resets += t_done.numpy()
    assert resets.min() >= 1
    assert (int(t_cnt) < cnt0) == (start > 0)


def test_rollout_plain_matches_jax_fused_rollout_one_block():
    """K10's plain version allocates per step in world order, which is JAX's
    fused_rollout with one block (block == N); 20 free-running steps."""
    n, T = 64, 20
    t_ts, t_cnt = _staggered_packed(n)
    t_w = tap.init_action_rng(n, seed=0, device=CPU)
    j_grid, j_steps, j_rng = _j_packed(t_ts)
    j_w = jap.init_action_rng(n, seed=0)
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    out = jax.jit(lambda g, s, r, c, w: jap.fused_rollout(g, s, r, c, w, T, block=n,
                                                          interpret=True))(
        j_grid, j_steps, j_rng, jnp.int32(n), j_w)
    j_grid, j_steps, j_rng, j_w, j_cnt, j_dcnt, j_chk = out
    t_ts, t_w, t_cnt, t_dcnt, t_chk = tap.fused_rollout(t_ts, t_cnt, t_w, T)
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    np.testing.assert_array_equal(t_dcnt.numpy(), np.asarray(j_dcnt))
    assert int(t_cnt) == int(j_cnt)
    _assert_packed(t_ts, j_grid, j_steps, j_rng, "final", FREE_TOL)
    # the checksum adds 20 x 4 free-running values per env
    np.testing.assert_allclose(t_chk.numpy(), np.asarray(j_chk), rtol=0, atol=80 * 1e-4)
    assert t_dcnt.dtype == torch.int32 and t_chk.dtype == torch.float32
    assert int(t_dcnt.sum()) >= n // 2


def test_pack_init_and_action_stream_match_jax():
    n = 13
    bstate, _ = t_reset(ta.Env(), n, 9, device=CPU)
    ts = tap.pack_state(bstate.env_states)
    init, cnt = tap.init_packed(n, 9, device=CPU)
    assert all(torch.equal(getattr(ts, f), getattr(init, f)) for f in ("st", "steps", "rng"))
    assert int(cnt) == 9 + n
    back = tap.unpack_state(ts)
    for f in FIELDS + ("steps", "rng_v"):
        assert torch.equal(getattr(back, f), getattr(bstate.env_states, f)), f
    j_grid, j_steps, j_rng, j_cnt = jap.init_packed(n, 9)
    _assert_packed(ts, j_grid, j_steps, j_rng, "init_packed", dict(rtol=0, atol=0))
    assert int(j_cnt) == int(cnt)
    j_packed = jap.pack_state(j_reset(ja.Env(), n, 9)[0].env_states)
    _assert_packed(ts, *j_packed, "pack_state", dict(rtol=0, atol=0))
    for seed in (0, 4):
        t_w, j_w = tap.init_action_rng(n, seed=seed, device=CPU), jap.init_action_rng(n, seed)
        np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
        counts = np.zeros(3, np.int64)
        for _ in range(40):
            t_w, t_a = tap.action_lcg_next(t_w)
            j_w, j_a = jap.action_lcg_next(j_w)
            np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
            np.testing.assert_array_equal(t_a.numpy(), np.asarray(j_a))
            counts += np.bincount(t_a.numpy().ravel(), minlength=3)
        assert counts.min() > 0 and counts.size == 3  # all three torques drawn


def test_wrappers_check_their_inputs():
    n = 4
    ts, cnt = tap.init_packed(n, device=CPU)
    acts = torch.zeros((n, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        tap.fused_step(dataclasses.replace(ts, st=ts.st[:, :3].contiguous()), cnt, acts)
    with pytest.raises(TypeError):
        tap.fused_step(dataclasses.replace(ts, steps=ts.steps.long()), cnt, acts)
    with pytest.raises(TypeError):
        tap.fused_step(ts, cnt.int(), acts)
    with pytest.raises(ValueError, match="16-byte"):
        tap.fused_step(dataclasses.replace(ts, st=torch.zeros(4 * n + 1)[1:].view(n, 4)),
                       cnt, acts)
    with pytest.raises(ValueError):
        tap.fused_rollout(ts, cnt, tap.init_action_rng(n, device=CPU), 0)


def test_rollout_kernel_is_chosen_on_the_card():
    """K10's two kernels (carry in shared memory, or in device memory) are
    chosen by N in ``ac_rollout`` on the card, which ``rollout_kernel``
    asks; the CPU has no such choice, and asking for it there is refused."""
    with pytest.raises(ValueError, match="CUDA"):
        tap.rollout_kernel(1024, "cpu")


def test_rollout_steps_are_limited_by_the_packed_done_count():
    """K10 packs each env's done count (at most T) above 9 bits of step
    count in one 32-bit word, so ``fused_rollout`` refuses a T past 2^23 - 1
    on every device, before it steps anything."""
    assert tap.MAX_ROLLOUT_STEPS == (2**32 - 1) >> 9
    n = 4
    ts, cnt = tap.init_packed(n, device=CPU)
    w = tap.init_action_rng(n, device=CPU)
    with pytest.raises(ValueError, match="8388607"):
        tap.fused_rollout(ts, cnt, w, tap.MAX_ROLLOUT_STEPS + 1)


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tap.init_packed(2), lambda: tap.init_action_rng(2),
                  lambda: make_fused_collect(ta.Env(), 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert tap.init_packed(2, device="cpu")[0].st.device.type == "cpu"
    assert tap.init_action_rng(2, device="cpu").device.type == "cpu"


def test_collector_matches_batched_step():
    """The collector's StepOutput equals the plain batched_step's, and its
    pack/unpack round-trips the BatchState."""
    n = 8
    env = ta.Env()
    fc = make_fused_collect(env, n, device=CPU)
    bstate, out = t_reset(env, n, device=CPU)
    bstate = BatchState(dataclasses.replace(bstate.env_states,
                                            steps=torch.from_numpy(_stagger(n) + 25)),
                        bstate.episode_counter)
    carry = fc.pack(bstate)
    rs = np.random.RandomState(7)
    for t in range(12):
        acts = torch.from_numpy(rs.randint(0, 3, size=(n, 1)).astype(np.int32))
        bstate, out = t_step(env, bstate, acts)
        carry, fout = fc.step(carry, acts)
        for f in ("obs", "state_obs", "action_mask", "active", "reward", "done"):
            got, ref = getattr(fout, f), getattr(out, f)
            assert got.dtype == ref.dtype and torch.equal(got, ref), (t, f)
    back = fc.unpack(carry)
    assert int(back.episode_counter) == int(bstate.episode_counter) > n
    for f in FIELDS + ("steps", "rng_v"):
        assert torch.equal(getattr(back.env_states, f), getattr(bstate.env_states, f)), f


def test_selfplay_rollout_and_update_match_jax():
    """Self-play PPO on Acrobot: a 16-step rollout with injected actions
    through the collector, then one PPO update on the JAX trajectory, both
    against JAX."""
    T, n = 16, 8
    common = dict(num_steps=T, hidden=32, num_layers=1, update_epochs=2,
                  num_minibatches=2, lr=1e-3)
    jt = j_selfplay.SelfPlayPPO(
        ja.Env(), n, j_selfplay.SelfPlayConfig(rollout_backend="jnp", **common), seed=0)
    tt = t_selfplay.SelfPlayPPO(ta.Env(), n, t_selfplay.SelfPlayConfig(**common),
                                seed=0, device="cpu")
    load_flax_params(tt.net, _np_params(jt.state["params"]))
    assert tt._fused.kernel
    acts = np.random.RandomState(2).randint(0, 3, size=(T, n, 1)).astype(np.int32)
    j_bstate, j_out, j_tr = jax_rollout_injected(jt, acts)
    t_bstate, t_out, t_tr = tt._rollout(torch.from_numpy(acts))
    for k in ("action", "reward", "done"):
        np.testing.assert_array_equal(t_tr[k].numpy(), np.asarray(j_tr[k]), err_msg=k)
    np.testing.assert_allclose(t_tr["obs"].numpy(), np.asarray(j_tr["obs"]), **FREE_TOL)
    for k in ("logp", "value"):
        np.testing.assert_allclose(t_tr[k].numpy(), np.asarray(j_tr[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    _assert_state(t_bstate.env_states, j_bstate.env_states, "final", FREE_TOL)
    assert int(t_bstate.episode_counter) == int(j_bstate.episode_counter)
    assert_update_matches_jax(jt, tt, j_tr, j_out, loss_atol=1e-6)
