"""The decentralized path's graphs on the CPU: ``CleanPPOAgent``'s act
(recording and not), reward credit and train, and ``DeviceVecEnv.n_step``
(``train/graphs.py``), against the JAX package and against eager stepping.

There is no card here, so ``tests/test_torch_graphs.py``'s ``CPUGraph``
stands in for the CUDA graph, with the capture rule answering yes
(``cpu_graphs``): its capture runs the body once more and restores what the
body writes in place (the agent's carry and buffer row, and for a train
its parameters, gradients and Adam state), its replays run the body on the
static inputs, write the static outputs and check that the agent's state
kept its storage.  The agents against JAX's jitted agent use
``tests/test_torch_agent.py``'s ``run_both`` and its tolerances: buffers
``atol 1e-6`` (integer fields exactly), each train's parameter change
``rtol 1e-4, atol 1e-7``, its metrics ``atol 1e-5``, the port taking JAX's
parameters and Adam state after each train.  Replayed against eager, and a
load into a captured agent against an eager agent loaded from the same
file: exactly (the same code on the same inputs).
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.envs import balance_beam as j_bb
from madrona_rl_envs_playground_tpu.envs import hanabi as j_hanabi
from madrona_rl_envs_playground_tpu_torch.api import BalanceVecGym, CartpoleVecGym, DeviceVecEnv
from madrona_rl_envs_playground_tpu_torch.api import vectorenv as t_vec
from madrona_rl_envs_playground_tpu_torch.envs import acrobot as t_acrobot
from madrona_rl_envs_playground_tpu_torch.envs import balance_beam as t_bb
from madrona_rl_envs_playground_tpu_torch.envs import cartpole as t_cartpole
from madrona_rl_envs_playground_tpu_torch.envs import hanabi as t_hanabi
from madrona_rl_envs_playground_tpu_torch.envs import overcooked as t_oc
from madrona_rl_envs_playground_tpu_torch.train import cleanrl_ppo as t_ppo
from madrona_rl_envs_playground_tpu_torch.train import graphs
from madrona_rl_envs_playground_tpu_torch.utils.checkpoint import load_pytree, save_pytree

from .test_torch_agent import HIDDEN, LR, N, T, run_both
from .test_torch_graphs import CPUGraph, stub_cuda  # noqa: F401
from .test_torch_hanabi import THREE_PLAYERS


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The agent's and the env's capture rule answering yes on the CPU,
    their graphs ``CPUGraph``s."""
    for mod in (t_ppo, t_vec):
        monkeypatch.setattr(mod, "captures", lambda device, collector=None: True)
        monkeypatch.setattr(mod, "LoopGraph", CPUGraph)
    return monkeypatch


def _clone(tree):
    return graphs.tree_map(torch.clone, tree)


def _assert_equal(a, b, what):
    for i, (x, y) in enumerate(zip(graphs.tree_leaves(a), graphs.tree_leaves(b), strict=True)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: leaf {i} differs"


# ---- the agents against JAX's jitted agent --------------------------------------

@pytest.mark.parametrize("target_kl", [None, 1e-7], ids=["no-kl", "kl"])
def test_replayed_agents_match_jax_on_balance(cpu_graphs, target_kl):
    """Ego and partner replaying their act, credit and train (and the env
    its step) over two trains each against JAX's jitted agents; with
    ``target_kl=1e-7`` the device-side stop fires in every train (the
    first epoch's step applied, the later ones selected back)."""
    trains = run_both(cpu_graphs, j_bb.Env(), t_bb.Env(), seed=1, captured=True,
                      target_kl=target_kl)
    if target_kl is not None:
        assert all(0 < applied < 4 for _, applied, _ in trains)
    else:
        assert all(applied == 4 for _, applied, _ in trains)


def test_replayed_agents_match_jax_on_turn_based_hanabi(cpu_graphs):
    """very_small 2-player Hanabi (rewards earned while a seat waits go to
    its last active slot, those before its first action of a game are
    dropped), with the stop."""
    cfg = dict(clip_vloss=False, norm_adv=False, target_kl=1e-7)
    trains = run_both(cpu_graphs, j_hanabi.Env(**j_hanabi.CONFIGS["very_small"]),
                      t_hanabi.Env(**t_hanabi.CONFIGS["very_small"]), seed=2, captured=True,
                      **cfg)
    assert any(applied < 4 for _, applied, _ in trains)


# ---- the env: replayed against eager stepping ----------------------------------

def _make_env(name):
    return {"balance": t_bb.Env, "cartpole": t_cartpole.Env, "acrobot": t_acrobot.Env,
            "hanabi": lambda: t_hanabi.Env(**t_hanabi.CONFIGS["very_small"]),
            "overcooked": lambda: t_oc.make("cramped_room", horizon=6)}[name]()


def _near_limit(bstate, name):
    """Acrobot's step counts set near its 501-step limit, so that its
    episodes end within the test; the other envs' state as it is."""
    if name != "acrobot":
        return bstate
    n = bstate.env_states.steps.shape[0]
    steps = (496 + torch.arange(n) % 5).to(bstate.env_states.steps.dtype)
    return dataclasses.replace(bstate, env_states=dataclasses.replace(bstate.env_states,
                                                                      steps=steps))


ENV_STEPS = 30  # Cartpole's first random episodes end after about 20 steps


@pytest.mark.parametrize("name", ["balance", "cartpole", "acrobot", "hanabi", "overcooked"])
def test_replayed_env_matches_eager(cpu_graphs, name):
    """``n_step`` replayed against eager stepping from the same state with
    the same legal actions: seat views, rewards, dones and the batch state
    exactly; a ``bstate`` assigned mid-way (a new carry) and a reset reach
    the replays through the graph's input copy; what a step returned is
    unchanged after the next, and ``bstate`` is the caller's own."""
    env = _make_env(name)
    replayed = DeviceVecEnv(env, N, device="cpu")
    assert replayed.captured and replayed._step_graph.owner is replayed
    cpu_graphs.undo()
    eager = DeviceVecEnv(env, N, device="cpu")
    assert not eager.captured
    rs = np.random.RandomState(3)
    kept, dones = [], 0
    for t in range(ENV_STEPS):
        if t == 4:
            b = _near_limit(eager.bstate, name)
            eager.bstate, replayed.bstate = b, b
        if t == 24:
            _assert_equal(replayed.n_reset(), eager.n_reset(), f"{name} reset")
        mask = eager.last_out.action_mask.numpy()
        acts = torch.from_numpy(np.array(
            [[rs.choice(np.nonzero(mask[n, p])[0]) for n in range(N)]
             for p in range(env.num_agents)], np.int32))
        got = replayed.n_step(acts)[:3]
        want = eager.n_step(acts)[:3]
        _assert_equal(got, want, f"{name} step {t}")
        _assert_equal(replayed.last_out, eager.last_out, f"{name} step {t} last_out")
        bstate = replayed.bstate
        _assert_equal(bstate, eager.bstate, f"{name} step {t} bstate")
        kept.append((got, _clone(got), bstate, _clone(bstate)))
        dones += int(want[2].sum())
    assert replayed._step_graph.graph is not None and dones > 0
    for t, (got, copy, bstate, bcopy) in enumerate(kept):
        _assert_equal(got, copy, f"{name} step {t} results after the later steps")
        _assert_equal(bstate, bcopy, f"{name} step {t} bstate after the later steps")


# ---- what the API hands out, and run_decentralized --------------------------------

def _pairing(seed=1, target_kl=None, num_updates=4):
    """scripts/torch_balance_train.py's pairing at the tests' size: ego and
    partner agents over a Balance Beam ``DeviceVecEnv``."""
    venv = DeviceVecEnv(t_bb.Env(), N, device="cpu")
    kw = dict(num_updates=num_updates, num_steps=T, lr=LR, hidden=HIDDEN, verbose=False,
              target_kl=target_kl)
    partner = t_ppo.CleanPPOAgent(venv, "partner", seed=seed + 1, **kw)
    venv.add_partner_agent(partner)
    return venv, t_ppo.CleanPPOAgent(venv, "ego", seed=seed, **kw), partner


@pytest.mark.parametrize("target_kl", [None, 1e-7], ids=["no-kl", "kl"])
def test_replayed_run_decentralized_equals_eager(cpu_graphs, target_kl):
    """``run_decentralized`` over three trains of each agent, replayed and
    eager from the same seeds: each curve entry is its own train's
    (entries differ, and stay as they were after the later trains), and
    the curves, the agents' parameters, Adam state and carries are equal
    exactly.  Every graph of the pairing took its capture, and the dropped
    graphs were collected once for each of the three owners."""
    collects = []
    cpu_graphs.setattr(gc, "collect", lambda *a: collects.append(1))
    venv, ego, partner = _pairing(target_kl=target_kl)
    assert venv.captured and ego.captured and partner.captured
    kept = []
    curve = t_ppo.run_decentralized(venv, ego, 4 * T,
                                    lambda u, m: kept.append((m, _clone(m))))
    assert len(curve) == len(kept) == 3
    for (m, copy), entry in zip(kept, curve):
        assert entry is m
        _assert_equal(m, copy, "a curve entry after the later trains")
    assert not torch.equal(curve[0]["v_loss"], curve[1]["v_loss"])
    graphs_of = [ego._record_graph, ego._update_graph, ego._train_graph, venv._step_graph,
                 partner._record_graph, partner._update_graph, partner._train_graph]
    assert all(g.graph is not None for g in graphs_of)
    assert ego._sample_graph.graph is None  # no unrecorded action was asked for
    assert len(collects) == 3
    cpu_graphs.undo()

    e_venv, e_ego, e_partner = _pairing(target_kl=target_kl)
    assert not (e_venv.captured or e_ego.captured)
    e_curve = t_ppo.run_decentralized(e_venv, e_ego, 4 * T)
    for got, want in zip(curve, e_curve, strict=True):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]) or (got[k].isnan() & want[k].isnan()), k
    for a, b in ((ego, e_ego), (partner, e_partner)):
        _assert_equal(a.update_state(), b.update_state(), f"{a.name} state")
    _assert_equal(venv.bstate, e_venv.bstate, "the env's state")


def test_returned_actions_and_views_stay(cpu_graphs):
    """The ego's actions, the seat views, rewards and dones that
    ``venv.step`` returned, and the unrecorded actions of ``get_action(...,
    record=False)``, unchanged after later steps through the same graphs;
    an agent that fills two seats of one step (its second act replays the
    graph of its first) hands out two arrays that stay apart."""
    venv, ego, partner = _pairing()
    obs = venv.reset()
    kept = []
    for _ in range(T + 3):  # across the first train
        act = ego.get_action(obs)
        free = ego.get_action(obs, record=False)
        out = venv.step(act)
        ego.update(out[1], out[2])
        kept.append(((act, free) + out[:3], _clone((act, free) + out[:3])))
        obs = out[0]
    for t, (got, copy) in enumerate(kept):
        _assert_equal(got, copy, f"step {t}")
    seats = venv._obs
    both = [ego.get_action(seats[0]), ego.get_action(seats[1])]
    both_copy = _clone(both)
    ego.get_action(seats[0])
    _assert_equal(both, both_copy, "one agent's actions for two seats")


# ---- the gym wrappers ------------------------------------------------------------

@pytest.mark.parametrize("name", ["cartpole", "balance"])
def test_replayed_gyms_match_eager_and_hand_out_copies(cpu_graphs, name):
    """``CartpoleVecGym`` and ``BalanceVecGym`` (the latter with a partner
    policy reading the ego's observations) over a replayed env against
    eager ones: the numpy results equal, and those of each step unchanged
    after the later steps."""
    def make():
        if name == "cartpole":
            return CartpoleVecGym(N, device="cpu")
        return BalanceVecGym(N, partner_fn=lambda o: (o[:, 0] + o[:, 3]).astype(np.int64) % 4, device="cpu")

    replayed = make()
    assert replayed.venv.captured
    cpu_graphs.undo()
    eager = make()
    rs = np.random.RandomState(5)
    np.testing.assert_array_equal(replayed.reset(), eager.reset())
    kept, dones = [], 0
    for _ in range(ENV_STEPS):
        acts = rs.randint(0, 2 if name == "cartpole" else 4, size=N)
        got, want = replayed.step(acts), eager.step(acts)
        for x, y in zip(got[:3], want[:3]):
            assert isinstance(x, np.ndarray)
            np.testing.assert_array_equal(x, y)
        kept.append((got[:3], [x.copy() for x in got[:3]]))
        dones += int(got[2].sum())
    for got, copy in kept:
        for x, y in zip(got, copy):
            np.testing.assert_array_equal(x, y)
    assert dones > 0


# ---- checkpoints and storage ----------------------------------------------------

def _cartpole_agent(seed):
    venv = DeviceVecEnv(t_cartpole.Env(), N, device="cpu")
    return venv, t_ppo.CleanPPOAgent(venv, f"cartpole{seed}", num_updates=5, num_steps=T,
                                     lr=LR, hidden=HIDDEN, verbose=False, seed=seed)


def _steps(venv, agent, obs, n):
    """``n`` steps of ``run_decentralized``'s loop from ``obs`` (no reset):
    (the last obs, the actions cloned, the trains' metrics)."""
    acts, trains = [], []
    for _ in range(n):
        act = agent.get_action(obs)
        obs, rew, done, _ = venv.step(act)
        agent.update(rew, done)
        acts.append(act.clone())
        if agent.step == 1 and agent._last_metrics is not None:
            trains.append(agent._last_metrics)
    return obs, acts, trains


def _snapshot(venv, agent):
    return dict(bstate=venv.bstate, obs=_clone(venv._obs), carry=_clone(agent.carry_state()),
                step=agent.step)


def _restore(venv, agent, snap):
    venv.bstate = snap["bstate"]
    venv._obs = _clone(snap["obs"])
    with torch.no_grad():
        for x, y in zip(agent.carry_state(), snap["carry"], strict=True):
            x.copy_(y)
    agent.step = snap["step"]


def test_load_into_a_captured_agent_continues_exactly(cpu_graphs, tmp_path):
    """``save`` after a train, ``load`` into the same agent after another:
    every tensor its graphs step keeps its storage, and the next steps and
    train (replayed) equal those of an eager agent of another seed loaded
    from the same file, from the same env state, carry and step."""
    path = str(tmp_path / "agent.pt")
    venv, a = _cartpole_agent(3)
    assert a.captured
    obs, _, trains = _steps(venv, a, venv.reset(), T + 2)
    assert len(trains) == 1
    a.save(path)
    snap = _snapshot(venv, a)
    ptrs = [t.data_ptr() for t in a.update_state()]
    _steps(venv, a, obs, T)
    a.load(path)
    assert [t.data_ptr() for t in a.update_state()] == ptrs
    _restore(venv, a, snap)
    got = _steps(venv, a, snap["obs"][0], T + 1)
    cpu_graphs.undo()
    e_venv, b = _cartpole_agent(8)
    assert not b.captured
    b.load(path)
    assert (b.updates, b.global_step) == (a.updates - 1, a.global_step - T - 1)
    _restore(e_venv, b, snap)
    want = _steps(e_venv, b, snap["obs"][0], T + 1)
    _assert_equal(got[1], want[1], "actions after the load")
    _assert_equal(got[2], want[2], "the train after the load")
    _assert_equal(a.update_state(), b.update_state(), "state after the train")


def test_card_checkpoint_loads_into_a_captured_cpu_agent(cpu_graphs, tmp_path):
    """A checkpoint in the card's form (Adam ``capturable`` with a tensor
    rate, the sampler a 16-byte Philox state) loads into a captured agent
    on the CPU in place: the parameters and moments equal the file's, the
    optimizer keeps ``capturable=False`` and a float rate, and the agent
    keeps its own sampler, whose form the file's does not fit."""
    venv, a = _cartpole_agent(3)
    _steps(venv, a, venv.reset(), T + 1)
    path, card = str(tmp_path / "cpu.pt"), str(tmp_path / "card.pt")
    a.save(path)
    blob = load_pytree(path)
    for group in blob["opt"]["param_groups"]:
        group.update(capturable=True, lr=torch.tensor(group["lr"], dtype=torch.float32))
    for st in blob["opt"]["state"].values():
        st["exp_avg"] = st["exp_avg"] + 1.0
    blob["sample_gen"] = torch.zeros(16, dtype=torch.uint8)
    save_pytree(card, blob)
    gen, ptrs = a.sample_gen.get_state(), [t.data_ptr() for t in a.update_state()]
    a.load(card)
    assert [t.data_ptr() for t in a.update_state()] == ptrs
    assert torch.equal(a.sample_gen.get_state(), gen)
    group = a.opt.param_groups[0]
    assert group["capturable"] is False and isinstance(group["lr"], float)
    for p, saved in zip(a.net.parameters(), blob["opt"]["state"].values()):
        assert torch.equal(a.opt.state[p]["exp_avg"], saved["exp_avg"])
    _steps(venv, a, venv._obs[0], T)  # its graphs replay on


def test_recorded_action_past_the_rollout_raises(cpu_graphs):
    """A recorded action at a step past the rollout's last row raises on
    the host before any graph runs (the device index would be out of the
    buffers)."""
    venv, a = _cartpole_agent(1)
    obs = venv.reset()
    a.step = T
    with pytest.raises(IndexError, match="rollout"):
        a.get_action(obs)
    assert a._record_graph.graph is None


# ---- the capture rule and the collection ----------------------------------------

def test_agent_capture_rule():
    """An agent captures on a CUDA device whatever its env; an env only
    over a kernel collector there; the CPU never."""
    from madrona_rl_envs_playground_tpu_torch.train.fused_collect import make_fused_collect

    kernel = make_fused_collect(t_bb.Env(), 4, "cpu")
    plain = make_fused_collect(t_hanabi.Env(**THREE_PLAYERS), 4, "cpu")
    assert graphs.captures("cuda") and not graphs.captures("cpu")
    assert graphs.captures("cuda", kernel) and not graphs.captures("cuda", plain)
    venv = DeviceVecEnv(t_bb.Env(), 4, device="cpu")
    agent = t_ppo.CleanPPOAgent(venv, "x", 2, verbose=False, num_steps=T, hidden=HIDDEN)
    assert not venv.captured and not agent.captured and agent._train_graph is None


class _Owner:
    """An owner of several graphs of its own methods (a cycle)."""

    def __init__(self, n):
        self.graphs = [graphs.LoopGraph(self.body, owner=self) for _ in range(n)]

    def body(self, x):
        return x + 1


def test_owner_collects_once(stub_cuda, monkeypatch):
    """The first capture of an owner's graphs collects the dropped graphs;
    its other graphs' first calls do not, another owner's first does, and
    a graph without an owner collects before each capture."""
    calls = []
    monkeypatch.setattr(gc, "collect", lambda *a: calls.append(1))
    one, two = _Owner(4), _Owner(2)
    for g in one.graphs:
        g(torch.zeros(1))
        g(torch.zeros(1))
    assert len(calls) == 1
    for g in two.graphs:
        g(torch.zeros(1))
    assert len(calls) == 2
    for _ in range(2):
        graphs.LoopGraph(lambda x: x * 2)(torch.zeros(1))
    assert len(calls) == 4
