"""The port's Cartpole env, K5/K6 plain versions, collector and trainer
against the JAX package.

Inputs come from numpy seeds; both sides run on the CPU; the JAX kernels run
in Pallas interpret mode, as ``tests/test_cartpole_pallas.py`` runs them.
Integer fields (LCG words, episode counter, done, done counts, actions) are
compared exactly.  Float rows are compared at ``rtol = atol = 1e-6`` where
both sides step from the same state (teacher-forced): XLA's and PyTorch's CPU
sin/cos may round the last bit differently.  Free-running trajectories let
that difference grow through the dynamics, so they are held at
``atol = 1e-4`` (measured drift after 100 steps: under 4e-6), with every done
flag and episode index still exact.  The CUDA kernels run only on the card,
where ``chip_smoke.py`` holds them against these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.core.batch import batched_reset as j_reset
from madrona_rl_envs_playground_tpu.core.batch import batched_step as j_step
from madrona_rl_envs_playground_tpu.envs import cartpole as jc
from madrona_rl_envs_playground_tpu.ops import cartpole_pallas as jcp
from madrona_rl_envs_playground_tpu.train import selfplay as j_selfplay
from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset as t_reset
from madrona_rl_envs_playground_tpu_torch.core.batch import batched_step as t_step
from madrona_rl_envs_playground_tpu_torch.core.types import BatchState
from madrona_rl_envs_playground_tpu_torch.envs import cartpole as tc
from madrona_rl_envs_playground_tpu_torch.models.cleanrl import load_flax_params
from madrona_rl_envs_playground_tpu_torch.ops import _build
from madrona_rl_envs_playground_tpu_torch.ops import cartpole as tcp
from madrona_rl_envs_playground_tpu_torch.train import selfplay as t_selfplay
from madrona_rl_envs_playground_tpu_torch.train.fused_collect import make_fused_collect

from .test_torch_train import _np_params, assert_update_matches_jax, jax_rollout_injected

CPU = torch.device("cpu")
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
FREE_TOL = dict(rtol=0, atol=1e-4)
FIELDS = ("x", "x_dot", "theta", "theta_dot")


def _t_state(j_state) -> tc.State:
    f = {k: torch.from_numpy(np.array(getattr(j_state, k))) for k in FIELDS}
    return tc.State(rng_v=torch.from_numpy(np.asarray(j_state.rng_v).astype(np.int64)), **f)


def _t_counter(c) -> torch.Tensor:
    return torch.tensor(int(np.asarray(c).astype(np.uint32)), dtype=torch.int64)


def _assert_state(t_state, j_state, msg, tol=STEP_TOL):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(t_state, f).numpy(),
                                   np.asarray(getattr(j_state, f)), **tol,
                                   err_msg=f"{msg} {f}")
    np.testing.assert_array_equal(t_state.rng_v.numpy(),
                                  np.asarray(j_state.rng_v).astype(np.int64),
                                  err_msg=f"{msg} rng_v")


def _assert_out(t_out, j_out, t, tol):
    for f in ("obs", "state_obs", "action_mask", "active", "reward", "done"):
        got, ref = getattr(t_out, f).numpy(), np.asarray(getattr(j_out, f))
        assert got.dtype == ref.dtype and got.shape == ref.shape, (f, got.dtype, ref.dtype)
        if got.dtype.kind == "f" and f in ("obs", "state_obs"):
            np.testing.assert_allclose(got, ref, **tol, err_msg=f"t={t} {f}")
        else:
            np.testing.assert_array_equal(got, ref, err_msg=f"t={t} {f}")


@pytest.mark.parametrize("n,start,seed", [(64, 0, 0), (37, 2**32 - 40, 1)])
def test_plain_env_matches_jax_teacher_forced(n, start, seed):
    """Each step starts both sides from the JAX state; the second case wraps
    the uint32 episode counter."""
    je, te = jc.Env(), tc.Env()
    j_bs, j_out = j_reset(je, n, start)
    _, t_out = t_reset(te, n, start, device=CPU)
    _assert_out(t_out, j_out, -1, STEP_TOL)
    step = jax.jit(j_step, static_argnums=(0,))
    rs = np.random.RandomState(seed)
    resets = 0
    for t in range(60):
        acts = rs.randint(0, 2, size=(n, 1)).astype(np.int32)
        t_in = BatchState(env_states=_t_state(j_bs.env_states),
                          episode_counter=_t_counter(j_bs.episode_counter))
        j_bs, j_out = step(je, j_bs, jnp.asarray(acts))
        t_bs, t_out = t_step(te, t_in, torch.from_numpy(acts))
        _assert_out(t_out, j_out, t, STEP_TOL)
        _assert_state(t_bs.env_states, j_bs.env_states, f"t={t}")
        assert int(t_bs.episode_counter) == int(j_bs.episode_counter), t
        resets += int(t_out.done.sum())
    assert resets > n  # random episodes last ~20 steps


def test_plain_env_matches_jax_free_running():
    """One untethered 100-step trajectory at N = 64."""
    n = 64
    je, te = jc.Env(), tc.Env()
    j_bs, _ = j_reset(je, n)
    t_bs, _ = t_reset(te, n, device=CPU)
    step = jax.jit(j_step, static_argnums=(0,))
    rs = np.random.RandomState(3)
    for t in range(100):
        acts = rs.randint(0, 2, size=(n, 1)).astype(np.int32)
        j_bs, j_out = step(je, j_bs, jnp.asarray(acts))
        t_bs, t_out = t_step(te, t_bs, torch.from_numpy(acts))
        _assert_out(t_out, j_out, t, FREE_TOL)
        _assert_state(t_bs.env_states, j_bs.env_states, f"t={t}", FREE_TOL)
        assert int(t_bs.episode_counter) == int(j_bs.episode_counter), t


def _j_packed(ts: tcp.TState):
    """The port's layout -> the JAX kernel's ([4, N] f32, [1, N] i32)."""
    return jnp.asarray(ts.st.numpy().T), jnp.asarray(ts.rng.numpy()[None, :])


def _assert_packed(t_ts, j_grid, j_rng, msg, tol=STEP_TOL):
    np.testing.assert_allclose(t_ts.st.numpy(), np.asarray(j_grid).T, **tol, err_msg=f"{msg} st")
    np.testing.assert_array_equal(t_ts.rng.numpy(), np.asarray(j_rng)[0], err_msg=f"{msg} rng")


def _edge_state(ts: tcp.TState, every: bool) -> tcp.TState:
    """Every pole at rest at x = 3, past the 2.4 limit, where a step moves x
    by tau * x_dot = 0 (every episode ends in the next step), or at 0 (none
    does); chip_smoke.py's edge_state."""
    st = torch.zeros_like(ts.st)
    st[:, 0] = 3.0 if every else 0.0
    return tcp.TState(st=st, rng=ts.rng)


# counter starts, then the two states the card's check also steps from:
# every world resetting in one step, and none
@pytest.mark.parametrize("start", [0, 2**32 - 64 - 50, "every_world_resets",
                                   "no_world_resets"])
def test_step_plain_matches_jax_fused_step(start):
    """K5's plain version against the JAX kernel on a 4-block grid (block
    16 of N = 64), so the SMEM counter carry between blocks is exercised;
    teacher-forced.  In the second case the counter starts 50 short of 2^32
    and wraps during the run; the last two take one step from
    ``_edge_state``.  The done flags, episode words and counter hold
    exactly, the state within STEP_TOL: the interpreted JAX kernel rounds
    a reset's draw differently by up to an ulp."""
    n = 64
    edge = isinstance(start, str)
    t_ts, t_cnt = tcp.init_packed(n, 0 if edge else start, device=CPU)
    if edge:
        t_ts = _edge_state(t_ts, start == "every_world_resets")
    cnt0 = int(t_cnt)
    j_step_k = jax.jit(lambda g, r, c, a: jcp.fused_step(g, r, c, a, block=16, interpret=True))
    rs = np.random.RandomState(5)
    resets = 0
    for t in range(1 if edge else 40):
        acts = rs.randint(0, 2, size=(n, 1)).astype(np.int32)
        j_grid, j_rng = _j_packed(t_ts)
        j_cnt = jnp.asarray(np.uint32(int(t_cnt)).view(np.int32))
        j_grid, j_rng, j_done, j_cnt = j_step_k(j_grid, j_rng, j_cnt, jnp.asarray(acts.T))
        t_ts, t_done, t_cnt = tcp.fused_step(t_ts, t_cnt, torch.from_numpy(acts))
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done), err_msg=f"t={t} done")
        assert int(t_cnt) == int(np.asarray(j_cnt).view(np.uint32)), t
        _assert_packed(t_ts, j_grid, j_rng, f"t={t}")
        t_ts = tcp.TState(st=torch.from_numpy(np.array(j_grid).T.copy()), rng=t_ts.rng)
        resets += int(t_done.sum())
    if edge:
        assert resets == (n if start == "every_world_resets" else 0)
        return
    assert resets > n
    assert (int(t_cnt) < cnt0) == (start > 0)


def test_rollout_plain_matches_jax_fused_rollout_one_block():
    """K6's plain version allocates per step in world order, which is JAX's
    fused_rollout with one block (block == N)."""
    n, T = 64, 70
    t_ts, t_cnt = tcp.init_packed(n, device=CPU)
    t_w = tcp.init_action_rng(n, seed=0, device=CPU)
    j_grid, j_rng, j_cnt = jcp.init_packed(n)
    j_w = jcp.init_action_rng(n, seed=0)
    _assert_packed(t_ts, j_grid, j_rng, "init")
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    out = jax.jit(lambda g, r, w, c: jcp.fused_rollout(g, r, w, c, T, block=n, interpret=True))(
        j_grid, j_rng, j_w, j_cnt)
    j_grid, j_rng, j_w, j_cnt, j_dcnt, j_chk = out
    t_ts, t_w, t_cnt, t_dcnt, t_chk = tcp.fused_rollout(t_ts, t_cnt, t_w, T)
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    np.testing.assert_array_equal(t_dcnt.numpy(), np.asarray(j_dcnt))
    assert int(t_cnt) == int(j_cnt)
    _assert_packed(t_ts, j_grid, j_rng, "final", FREE_TOL)
    # the checksum adds 70 free-running x values per env
    np.testing.assert_allclose(t_chk.numpy(), np.asarray(j_chk), rtol=0, atol=70 * 1e-4)
    assert t_dcnt.dtype == torch.int32 and t_chk.dtype == torch.float32
    assert int(t_dcnt.sum()) > n


def test_pack_unpack_and_action_stream_match_jax():
    n = 13
    bstate, _ = t_reset(tc.Env(), n, 9, device=CPU)
    ts = tcp.pack_state(bstate.env_states)
    init, cnt = tcp.init_packed(n, 9, device=CPU)
    assert torch.equal(ts.st, init.st) and torch.equal(ts.rng, init.rng)
    assert int(cnt) == 9 + n
    back = tcp.unpack_state(ts)
    for f in FIELDS + ("rng_v",):
        assert torch.equal(getattr(back, f), getattr(bstate.env_states, f)), f
    j_grid, j_rng, _ = jcp.init_packed(n, 9)
    _assert_packed(ts, j_grid, j_rng, "init_packed", dict(rtol=0, atol=0))
    t_w, j_w = tcp.init_action_rng(n, seed=4, device=CPU), jcp.init_action_rng(n, seed=4)
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    for _ in range(5):
        t_w, t_a = tcp.action_lcg_next(t_w)
        j_w, j_a = jcp.action_lcg_next(j_w)
        np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
        np.testing.assert_array_equal(t_a.numpy(), np.asarray(j_a))


def test_step_scan_words_are_cached_per_device_and_stream():
    """The step kernels' scan words (``ops._build.step_scan``, shared by K5,
    K7 and K9) on the CPU device: zero, grown for a larger N, the same
    buffer again for a smaller N on the same key, and a buffer of its own
    for another stream."""
    saved = dict(_build._STEP_SCAN)
    _build._STEP_SCAN.clear()
    try:
        # two 64-bit head words, then one a tile of at least 256 envs
        assert [_build.step_scan_ints(n) for n in (1, 256, 257, 1 << 20)] == [6, 6, 8, 8196]
        small = _build.step_scan(100, CPU, 7)
        assert small.dtype == torch.int32 and small.numel() == 6 and not small.any()
        big = _build.step_scan(100_000, CPU, 7)
        assert big.numel() == _build.step_scan_ints(100_000) > small.numel()
        assert not big.any()
        assert _build.step_scan(129, CPU, 7) is big
        other = _build.step_scan(129, CPU, 8)
        assert other is not big and other.numel() == 6 and not other.any()
        assert set(_build._STEP_SCAN) == {(0, 7), (0, 8)}
    finally:
        _build._STEP_SCAN.clear()
        _build._STEP_SCAN.update(saved)


def test_wrappers_check_their_inputs():
    n = 4
    ts, cnt = tcp.init_packed(n, device=CPU)
    acts = torch.zeros((n, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        tcp.fused_step(tcp.TState(ts.st[:, :3].contiguous(), ts.rng), cnt, acts)
    with pytest.raises(TypeError):
        tcp.fused_step(tcp.TState(ts.st.double(), ts.rng), cnt, acts)
    with pytest.raises(TypeError):
        tcp.fused_step(ts, cnt.int(), acts)
    with pytest.raises(ValueError, match="16-byte"):
        tcp.fused_step(tcp.TState(torch.zeros(4 * n + 1)[1:].view(n, 4), ts.rng), cnt, acts)
    with pytest.raises(ValueError):
        tcp.fused_rollout(ts, cnt, tcp.init_action_rng(n, device=CPU), 0)


def test_rollout_kernel_is_chosen_on_the_card():
    """K6's two kernels (carry in shared memory, or in device memory) are
    chosen by N in ``cp_rollout`` on the card, which ``rollout_kernel``
    asks; the CPU has no such choice, and asking for it there is refused."""
    with pytest.raises(ValueError, match="CUDA"):
        tcp.rollout_kernel(1024, "cpu")


def test_collector_matches_batched_step():
    """The collector's StepOutput equals the plain batched_step's, and its
    pack/unpack round-trips the BatchState (as tests/test_fused_collect.py
    holds the JAX collectors)."""
    n = 8
    env = tc.Env()
    fc = make_fused_collect(env, n, device=CPU)
    bstate, out = t_reset(env, n, device=CPU)
    carry = fc.pack(bstate)
    rs = np.random.RandomState(7)
    for t in range(30):
        acts = torch.from_numpy(rs.randint(0, 2, size=(n, 1)).astype(np.int32))
        bstate, out = t_step(env, bstate, acts)
        carry, fout = fc.step(carry, acts)
        for f in ("obs", "state_obs", "action_mask", "active", "reward", "done"):
            got, ref = getattr(fout, f), getattr(out, f)
            assert got.dtype == ref.dtype and torch.equal(got, ref), (t, f)
    back = fc.unpack(carry)
    assert int(back.episode_counter) == int(bstate.episode_counter) > n
    for f in FIELDS + ("rng_v",):
        assert torch.equal(getattr(back.env_states, f), getattr(bstate.env_states, f)), f


def _trainers(T=24, n=8):
    common = dict(num_steps=T, hidden=32, num_layers=1, update_epochs=2,
                  num_minibatches=2, lr=1e-3)
    jt = j_selfplay.SelfPlayPPO(
        jc.Env(), n, j_selfplay.SelfPlayConfig(rollout_backend="jnp", **common), seed=0)
    tt = t_selfplay.SelfPlayPPO(tc.Env(), n, t_selfplay.SelfPlayConfig(**common),
                                seed=0, device="cpu")
    load_flax_params(tt.net, _np_params(jt.state["params"]))
    return jt, tt


def test_selfplay_rollout_and_update_match_jax():
    """A rollout with injected actions through the collector, then one PPO
    update on the JAX trajectory, both against JAX."""
    jt, tt = _trainers()
    assert tt._fused.kernel
    acts = np.random.RandomState(2).randint(0, 2, size=(24, 8, 1)).astype(np.int32)
    j_bstate, j_out, j_tr = jax_rollout_injected(jt, acts)
    t_bstate, t_out, t_tr = tt._rollout(torch.from_numpy(acts))
    for k in ("action", "reward", "done"):
        np.testing.assert_array_equal(t_tr[k].numpy(), np.asarray(j_tr[k]), err_msg=k)
    assert np.asarray(j_tr["done"]).any()
    np.testing.assert_allclose(t_tr["obs"].numpy(), np.asarray(j_tr["obs"]), **FREE_TOL)
    for k in ("logp", "value"):
        np.testing.assert_allclose(t_tr[k].numpy(), np.asarray(j_tr[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    _assert_state(t_bstate.env_states, j_bstate.env_states, "final", FREE_TOL)
    assert int(t_bstate.episode_counter) == int(j_bstate.episode_counter)
    # the policy loss is a mean of O(1) terms that nearly cancel (-3e-4 here),
    # summed in other orders by the two frameworks: float32 rounding of the
    # terms leaves ~1e-7 absolute
    assert_update_matches_jax(jt, tt, j_tr, j_out, loss_atol=1e-6)
