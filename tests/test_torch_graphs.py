"""The trainers' captured loops (``train/graphs.py``) against the JAX package.

There is no card here, so ``CPUGraph`` stands in for the CUDA graph: a
``LoopGraph`` whose capture runs the loop once on its static inputs (its
launches taken back out, its generators' states and, for a trainer's
update and the decentralized agent's bodies, the tensors they write in
place restored, as a capture runs
nothing) and whose replay runs the loop again on the static inputs and
copies the result into the static outputs.  Consecutive replays therefore
return the same buffers, as the card's replays do, and these tests hold the
loop bodies the card captures (``SelfPlayPPO._rollout_body`` and
``_scan_body``, ``MAPPORunner._collect_body``, ``returns_scan`` and
``_eval_body``) run that way against JAX's ``lax.scan`` versions, from the
same weights and injected actions.  A stub of ``torch.cuda``'s graph calls
checks the launch accounting and the capture's failure path; the capture
rule is a pure function and needs no card.

Tolerances: integer and bool outputs exactly; log-probs, values, hidden
states, the credit routing, the advantages and returns ``atol 1e-5``
(float32: the two frameworks reduce in other orders, and JAX's plain GAE is
an associative scan where the port loops), as ``tests/test_torch_train.py``
and ``tests/test_torch_hanabi_train.py`` state them; the eval score
``rel 1e-5`` (a float64 sum of float32 rewards on each side).
"""

import contextlib
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.envs import balance_beam as j_balance
from madrona_rl_envs_playground_tpu.envs import overcooked2 as j_oc2
from madrona_rl_envs_playground_tpu.models.cleanrl import CleanRLNetwork as JNet
from madrona_rl_envs_playground_tpu.train import cleanrl_ppo as j_ppo
from madrona_rl_envs_playground_tpu.train import mappo as jm
from madrona_rl_envs_playground_tpu.train import selfplay as j_selfplay
from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset, batched_step
from madrona_rl_envs_playground_tpu_torch.envs import balance_beam as t_balance
from madrona_rl_envs_playground_tpu_torch.envs import hanabi as th
from madrona_rl_envs_playground_tpu_torch.envs import overcooked as t_oc
from madrona_rl_envs_playground_tpu_torch.envs import overcooked2 as t_oc2
from madrona_rl_envs_playground_tpu_torch.models import mappo_nets as t_nets
from madrona_rl_envs_playground_tpu_torch.ops import hanabi as t_hk
from madrona_rl_envs_playground_tpu_torch.ops import overcooked as t_ok
from madrona_rl_envs_playground_tpu_torch.train import graphs
from madrona_rl_envs_playground_tpu_torch.train import mappo as tm
from madrona_rl_envs_playground_tpu_torch.train import selfplay as t_selfplay
from madrona_rl_envs_playground_tpu_torch.train.fused_collect import make_fused_collect
from madrona_rl_envs_playground_tpu_torch.train.mappo import runner as t_runner

from .test_torch_hanabi import THREE_PLAYERS, legal_actions
from .test_torch_hanabi_train import N as HN
from .test_torch_hanabi_train import T as HT
from .test_torch_hanabi_train import _trainers as hanabi_trainers
from .test_torch_mappo import _jax_collect_injected, _np
from .test_torch_mappo_recurrent import _perturbed
from .test_torch_train import _trainers as cramped_trainers
from .test_torch_train import jax_rollout_injected

F32 = dict(atol=1e-5, rtol=0)
CPU = torch.device("cpu")


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **F32)


def _overlapping(t: torch.Tensor) -> bool:
    return any(s == 0 and n > 1 for s, n in zip(t.stride(), t.shape))


# SelfPlayPPO's, RMAPPOTrainer's and CleanPPOAgent's updates
UPDATE_BODIES = ("_update_body", "_train_body", "_train_impl")
CARRY_BODIES = ("_act", "_update_impl")  # CleanPPOAgent's act and reward credit


def _held(fn):
    """The tensors a body writes in place: a trainer's or the agent's update
    its ``update_state``, the agent's act (a partial of ``_act``) and reward
    credit its ``carry_state``; none for the other loops."""
    fn = getattr(fn, "func", fn)
    name = getattr(fn, "__name__", None)
    if name in UPDATE_BODIES:
        return fn.__self__.update_state()
    if name in CARRY_BODIES:
        return fn.__self__.carry_state()
    return []


class CPUGraph(graphs.LoopGraph):
    """``LoopGraph`` with its CUDA calls replaced by running the loop (see
    the module docstring).  A replay of a trainer's update, or of the
    agent's act, reward credit or train, also checks that it steps the
    very tensors the capture saw (the same storage), as a CUDA graph
    would."""

    def _warm_up(self, args):
        self.stream = "cpu"
        return self.fn(*args)

    def _capture(self, args):
        self._inputs = graphs.tree_map(torch.clone, args)
        states = [g.get_state() for g in self.generators]
        held = _held(self.fn)
        saved = [t.clone() for t in held]
        before = graphs.launch_counts()
        self._outputs = self.fn(*self._inputs)
        after = graphs.launch_counts()
        self.launches = {k: after[k] - n for k, n in before.items() if after[k] != n}
        graphs.add_launches(self.launches, -1)
        for g, st in zip(self.generators, states):
            g.set_state(st)
        with torch.no_grad():
            for t, s in zip(held, saved, strict=True):
                t.copy_(s)
        self.held_ptrs = [t.data_ptr() for t in held]
        self.graph = self

    def replay(self):
        assert [t.data_ptr() for t in _held(self.fn)] == self.held_ptrs, \
            "the state the body writes was replaced since the capture"
        out = self.fn(*self._inputs)
        for dst, src in zip(graphs.tree_leaves(self._outputs), graphs.tree_leaves(out),
                            strict=True):
            if dst is not src:
                # a broadcast output (a seat axis expanded) is rebound
                dst.set_(src) if _overlapping(dst) else dst.copy_(src)


def _three_replays(graph, first_args, second_args):
    """The warm-up and the capture (``first_args``), then two replays: from
    ``first_args`` and from ``second_args(first replay's outputs)``.  Returns
    (warm-up result, first replay cloned, first replay, second replay)."""
    warm = graph(*first_args)
    first = graph(*first_args)
    kept = graphs.tree_map(torch.clone, first)
    second = graph(*second_args(first))
    return warm, kept, first, second


def _assert_same_buffers(a, b):
    """Two replays returned the same static buffers."""
    for x, y in zip(graphs.tree_leaves(a), graphs.tree_leaves(b), strict=True):
        assert x is y


# ---- self-play: the rollout and the advantage scans ---------------------------------

def _hanabi_schedule(steps):
    env = th.Env(**th.CONFIGS["very_small"])
    bstate, out = batched_reset(env, HN, device="cpu")
    rs = np.random.RandomState(6)
    acts = []
    for _ in range(steps):
        a = legal_actions(rs, out.action_mask.numpy())
        bstate, out = batched_step(env, bstate, torch.from_numpy(a))
        acts.append(a)
    return np.stack(acts)


def _selfplay_case(name):
    """(JAX trainer, port trainer, two [T, N, P] action schedules)."""
    if name == "hanabi":
        jt, tt = hanabi_trainers()
        acts = _hanabi_schedule(2 * HT)
        return jt, tt, acts[:HT], acts[HT:]
    jt, tt = cramped_trainers()
    rs = np.random.RandomState(9)
    acts = rs.choice(6, size=(16, 4, 2), p=[.15, .15, .15, .15, .05, .35]).astype(np.int32)
    return jt, tt, acts[:8], acts[8:]


def _jax_scans(jt, tr, out):
    """JAX's credit routing, bootstrap value and GAE (``SelfPlayPPO.
    _advantage``'s scans): (rewards, advantages, returns, active or None)."""
    P, M = jt.env.num_agents, tr["reward"].shape[1]
    next_value = jt.net.apply(jt.state["params"], out.state_obs.reshape(M, -1),
                              method=JNet.get_value)
    next_done = jnp.repeat(out.done[:, None], P, axis=1).reshape(M)
    if "active" in tr:
        rewards, slot_dones = j_selfplay.credit_rewards(tr["reward"], tr["active"], tr["done"])
        buf = j_ppo.Rollout(obs=None, states=None, actions=None, action_masks=None,
                            logprobs=None, rewards=rewards, dones=slot_dones,
                            active=tr["active"], values=tr["value"])
        adv, ret, active = j_ppo.active_masked_gae(buf, next_value, next_done,
                                                   out.active.reshape(M), 0.99, 0.95)
        return rewards, adv, ret, active
    slot_dones = jnp.concatenate([jnp.zeros_like(tr["done"][:1]), tr["done"][:-1]])
    adv, ret = j_ppo.plain_gae(tr["reward"], slot_dones, tr["value"], next_value, next_done,
                               0.99, 0.95)
    return tr["reward"], adv, ret, None


@pytest.fixture(scope="module", params=["cramped_room", "hanabi"])
def selfplay_runs(request):
    """JAX's two consecutive rollouts and their scans, and the port's
    trainer and action schedules."""
    jt, tt, a1, a2 = _selfplay_case(request.param)
    runs = []
    for acts in (a1, a2):
        bstate, out, tr = jax_rollout_injected(jt, acts)
        runs.append((bstate, out, tr, _jax_scans(jt, tr, out)))
        jt.state = dict(jt.state, bstate=bstate, out=out)
    return tt, a1, a2, runs


def _scan_args(tr, out, masked):
    return (tr["reward"], tr["done"], tr["value"], tr.get("active"), out.state_obs, out.done,
            out.active if masked else None)


def test_replayed_rollouts_match_jax(selfplay_runs):
    """The rollout body replayed twice on the same buffers: each replay
    equals JAX's rollout from the same state with the same actions, and
    the first, cloned, still equals JAX's first after the second replay
    overwrote its buffers."""
    tt, a1, a2, runs = selfplay_runs
    fused = tt._fused
    graph = CPUGraph(lambda carry, out, acts: tt._rollout_body(carry, out, acts),
                     [tt.sample_gen])
    start = (fused.pack(tt.state["bstate"]), tt.state["out"], torch.from_numpy(a1))
    warm, kept, first, second = _three_replays(
        graph, start, lambda r: (r[0], r[1], torch.from_numpy(a2)))
    _assert_same_buffers(first, second)
    for (carry, out, tr), (j_bstate, j_out, j_tr, _) in ((warm, runs[0]), (kept, runs[0]),
                                                          (second, runs[1])):
        for k in ("obs", "state_obs", "mask", "active", "action", "reward", "done"):
            if k in j_tr:
                np.testing.assert_array_equal(tr[k].numpy(), np.asarray(j_tr[k]), err_msg=k)
        _close(tr["logp"], j_tr["logp"])
        _close(tr["value"], j_tr["value"])
        np.testing.assert_array_equal(out.obs.numpy(), np.asarray(j_out.obs))
        np.testing.assert_array_equal(out.done.numpy(), np.asarray(j_out.done))
        bstate = fused.unpack(carry)
        for f in j_bstate.env_states.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(bstate.env_states, f).numpy(),
                                          np.asarray(getattr(j_bstate.env_states, f)),
                                          err_msg=f)
        assert int(bstate.episode_counter) == int(j_bstate.episode_counter)
    assert any(np.asarray(r[2]["done"]).any() for r in runs)


def test_replayed_scans_match_jax(selfplay_runs):
    """The advantage scans (credit routing, bootstrap value, plain or
    active-masked GAE) replayed on the two rollouts' buffers against JAX's
    scans of the same buffers."""
    tt, _, _, runs = selfplay_runs
    masked = tt._masked
    bufs = []
    for j_bstate, j_out, j_tr, _ in runs:
        tr = {k: torch.from_numpy(np.array(j_tr[k])) for k in j_tr}
        out = types.SimpleNamespace(**{f: torch.from_numpy(np.array(getattr(j_out, f)))
                                       for f in ("state_obs", "done", "active")})
        bufs.append(_scan_args(tr, out, masked))
    graph = CPUGraph(tt._scan_body)
    warm, kept, first, second = _three_replays(graph, bufs[0], lambda _: bufs[1])
    _assert_same_buffers(first, second)
    for got, (_, _, _, want) in ((warm, runs[0]), (kept, runs[0]), (second, runs[1])):
        rewards, adv, ret, active = got
        _close(rewards, want[0])
        _close(adv, want[1])
        _close(ret, want[2])
        assert (active is None) == (want[3] is None) == (not masked)
        if masked:
            np.testing.assert_array_equal(active.numpy(), np.asarray(want[3]))


# ---- MAPPO: the collect, the returns and the eval -----------------------------------

def _mappo_runners(recurrent, env=("overcooked2", 5), steps=8, perturb=False):
    kw = dict(episode_length=steps, n_rollout_threads=3, hidden_size=16, layer_N=1,
              ppo_epoch=1, seed=0, use_recurrent_policy=recurrent, data_chunk_length=4)
    if env[0] == "balance":
        j_env, t_env = j_balance.Env(), t_balance.Env()
    else:
        j_env = j_oc2.make("cramped_room", horizon=env[1])
        t_env = t_oc2.make("cramped_room", horizon=env[1])
    jr = jm.MAPPORunner(jm.MAPPOConfig(**kw), j_env)
    tr = tm.MAPPORunner(tm.MAPPOConfig(**kw), t_env, device=CPU)
    ps = jr.trainer.state.policy
    if perturb:  # away from the init's near-ties, so greedy play scores
        ps = ps.replace(actor_params=_perturbed(ps.actor_params, 3))
        jr.trainer.state = jr.trainer.state.replace(policy=ps)
    t_nets.load_mappo_params(tr.policy.actor, tr.policy.critic, _np(ps.actor_params),
                             _np(ps.critic_params))
    return jr, tr


@pytest.mark.parametrize("recurrent", [False, True])
def test_replayed_collect_and_returns_match_jax(recurrent):
    """The collect body replayed twice on the same buffers (cramped_room,
    horizon 5: episodes end inside each collect and at their seam, so the
    GRU's states are zeroed) against JAX's ``_collect_impl``, the first
    replay cloned still equal after the second; the returns of the second
    through a replayed ``returns_scan`` against JAX's ``_compute``."""
    jr, tr = _mappo_runners(recurrent)
    T, n = tr.cfg.episode_length, tr.N
    rs = np.random.RandomState(8)
    acts = [rs.randint(0, 6, size=(T, n, 2)).astype(np.int32) for _ in range(2)]
    j_runs = []
    for a in acts:
        jr.bstate, jr.out, jr._rnn, jr._rnnc, jr._masks, _, j_tr = _jax_collect_injected(jr, a)
        j_runs.append((j_tr, jr.bstate, jr.out, jr._rnn, jr._rnnc, jr._masks))
    graph = CPUGraph(lambda carry, out, masks, rnn, rnnc, a: tr._collect_body(
        carry, out, masks, rnn, rnnc, a), [tr.sample_gen])
    start = (tr._fused.pack(tr.bstate), tr.out, tr._masks, tr._rnn, tr._rnnc,
             torch.from_numpy(acts[0]))
    warm, kept, first, second = _three_replays(
        graph, start, lambda r: r[:5] + (torch.from_numpy(acts[1]),))
    _assert_same_buffers(first, second)
    for got, (j_tr, j_bstate, j_out, j_rnn, j_rnnc, j_masks) in (
            (warm, j_runs[0]), (kept, j_runs[0]), (second, j_runs[1])):
        carry, out, masks, rnn, rnnc, t_tr = got
        for k in ("share_obs", "obs", "actions", "rewards", "masks", "active", "avail", "done"):
            np.testing.assert_array_equal(t_tr[k].numpy(), np.asarray(j_tr[k]), err_msg=k)
        for k in ("logp", "values") + (("rnn", "rnnc") if recurrent else ()):
            _close(t_tr[k], j_tr[k])
        np.testing.assert_array_equal(masks.numpy(), np.asarray(j_masks))
        np.testing.assert_array_equal(out.obs.numpy(), np.asarray(j_out.obs))
        assert int(tr._fused.unpack(carry).episode_counter) == int(j_bstate.episode_counter)
        if recurrent:
            _close(rnn, j_rnn)
            _close(rnnc, j_rnnc)
    assert any(np.asarray(r[0]["done"]).any() for r in j_runs)

    # the second collect's buffer and returns, the returns loop replayed
    carry, tr.out, tr._masks, tr._rnn, tr._rnnc, t_tr = second
    tr.bstate = tr._fused.unpack(carry)
    cfg = tr.cfg
    tr._returns_graph = CPUGraph(functools.partial(
        tm.buffer.returns_scan, gamma=cfg.gamma, gae_lambda=cfg.gae_lambda, use_gae=cfg.use_gae,
        use_proper_time_limits=cfg.use_proper_time_limits))
    for _ in range(3):  # warm-up and capture, then replays on the same buffer
        t_buf = tr._compute(tr._tr_to_buffer(t_tr, tr._masks, tr.out.active.float()))
    j_tr, _, j_out, _, j_rnnc, j_masks = j_runs[1]
    j_buf = jr._compute(jr.trainer.state, jr._tr_to_buffer(j_tr, j_masks,
                                                           j_out.active.astype(jnp.float32)),
                        j_out, j_rnnc, j_masks)
    _close(t_buf.returns, j_buf.returns)


@contextlib.contextmanager
def _cpu_graphs():
    """The runner's capture rule answering yes on the CPU, its graphs
    ``CPUGraph``s: its own calls then take the graph path."""
    rule, cls = t_runner.captures, t_runner.LoopGraph
    t_runner.captures, t_runner.LoopGraph = (lambda device, collector: True), CPUGraph
    try:
        yield
    finally:
        t_runner.captures, t_runner.LoopGraph = rule, cls


@pytest.mark.parametrize("recurrent", [False, True])
def test_replayed_evaluate_matches_jax(recurrent):
    """``evaluate(episodes=3)`` through the eval block's graph (the first
    block its warm-up, the next two replays chained from its outputs) on
    Balance Beam, whose episodes end every 3 steps: the score equals JAX's
    ``evaluate``, and a second call, all replays, gives it again."""
    jr, tr = _mappo_runners(recurrent, env=("balance", 0), perturb=True)
    with _cpu_graphs():
        scores = [tr.evaluate(episodes=3) for _ in range(2)]
    assert isinstance(tr._eval_graphs[True], CPUGraph)
    assert scores[0] == scores[1] == pytest.approx(jr.evaluate(episodes=3), rel=1e-5)
    assert scores[0] != 0


# ---- the launch accounting and the capture rule -------------------------------------

class _StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: records what the helper asks
    of it; a replay runs nothing."""

    made = []

    def __init__(self):
        self.generators, self.replays = [], 0
        _StubGraph.made.append(self)

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1


class _StubStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stub_cuda(monkeypatch):
    """``torch.cuda``'s stream and graph calls stubbed, the launch counts
    private to the test."""
    modes = []

    @contextlib.contextmanager
    def graph(g, stream=None, capture_error_mode="global"):
        modes.append(capture_error_mode)
        yield

    _StubGraph.made = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "Stream", _StubStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _StubStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    for mod in graphs.LAUNCH_MODULES:
        monkeypatch.setattr(mod, "LAUNCHES", dict(mod.LAUNCHES))
    return modes


def _launching_loop(x):
    """A loop of three K1 steps and one K3 step, as the wrappers count them."""
    for _ in range(3):
        t_ok.LAUNCHES["fused_step"] += 1
        x = x + 1
    t_hk.LAUNCHES["fused_step"] += 1
    return {"y": x * 2}


def test_replay_adds_the_capture_launches(stub_cuda):
    """The warm-up counts its launches; the capture's are taken back out; a
    replay adds exactly the capture's delta, copies its arguments into the
    static inputs and returns the static outputs; the generators are
    registered and the capture is thread-local."""
    gen = torch.Generator()
    graph = graphs.LoopGraph(_launching_loop, [gen])
    k1, k3 = dict(t_ok.LAUNCHES), dict(t_hk.LAUNCHES)
    out = graph(torch.zeros(4))
    assert torch.equal(out["y"], torch.full((4,), 6.0))
    assert t_ok.LAUNCHES["fused_step"] == k1["fused_step"] + 3
    assert graph.launches == {(t_ok.__name__, "fused_step"): 3, (t_hk.__name__, "fused_step"): 1}
    (g,) = _StubGraph.made
    assert g.generators == [gen] and stub_cuda == ["thread_local"]
    for i in range(1, 3):
        x = torch.full((4,), float(i))
        res = graph(x)
        assert res is graph._outputs and g.replays == i
        assert torch.equal(graph._inputs[0], x) and graph._inputs[0] is not x
        assert t_ok.LAUNCHES["fused_step"] == k1["fused_step"] + 3 * (i + 1)
        assert t_hk.LAUNCHES["fused_step"] == k3["fused_step"] + i + 1
    assert t_ok.LAUNCHES["fused_rollout"] == k1["fused_rollout"]


def test_failed_capture_raises_and_counts_nothing(stub_cuda):
    """A loop that fails inside the capture raises (no eager fallback), and
    the launches the capture counted before it failed are taken back out."""
    calls = []

    def loop(x):
        t_ok.LAUNCHES["fused_step"] += 1
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("operation not permitted when stream is capturing")
        return x + 1

    graph = graphs.LoopGraph(loop)
    before = t_ok.LAUNCHES["fused_step"]
    with pytest.raises(RuntimeError, match="capturing"):
        graph(torch.zeros(2))
    assert t_ok.LAUNCHES["fused_step"] == before + 1  # the warm-up's launch
    assert graph.graph is None


def _stub_mesh():
    return types.SimpleNamespace(local_size=lambda n: n // 2, device=CPU)


@pytest.mark.parametrize("device,env,mesh,captured", [
    ("cuda", "cramped_room", False, True),
    ("cuda", "hanabi", False, True),
    ("cuda", "cramped_room", True, True),
    ("cpu", "cramped_room", False, False),
    ("cuda", "hanabi", True, False),
    ("cuda", "hanabi_3p", False, False),
])
def test_capture_rule(device, env, mesh, captured):
    """A kernel collector on the card is captured (K1 on a mesh too: its
    step holds no collective); the CPU, and the plain collector with or
    without a mesh, are not."""
    e = {"cramped_room": lambda: t_oc.make("cramped_room"),
         "hanabi": lambda: th.Env(**th.CONFIGS["very_small"]),
         "hanabi_3p": lambda: th.Env(**THREE_PLAYERS)}[env]()
    collector = make_fused_collect(e, 8, CPU, mesh=_stub_mesh() if mesh else None)
    assert graphs.captures(device, collector) is captured


def test_trainers_on_the_cpu_run_eagerly():
    """On the CPU neither trainer holds a graph, and their updates run."""
    env = t_oc.make("cramped_room", horizon=6)
    sp = t_selfplay.SelfPlayPPO(env, 2, t_selfplay.SelfPlayConfig(
        num_steps=4, hidden=8, num_layers=1, update_epochs=1), device="cpu")
    mr = tm.MAPPORunner(tm.MAPPOConfig(episode_length=4, n_rollout_threads=2, hidden_size=8,
                                       layer_N=1, ppo_epoch=1), t_oc2.make("cramped_room"),
                        device=CPU)
    assert not sp.captured and not mr.captured
    assert sp._rollout_graph is None and mr._collect_graph is None
    sp.train_step()
    mr.update(0, 1)
    mr.evaluate(1)
    assert mr._eval_graphs == {}
