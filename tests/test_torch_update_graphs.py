"""The trainers' captured updates (``train/graphs.py``) against the JAX package.

``SelfPlayPPO._update_body`` (the PPO epochs: forward, loss, backward, the
global-norm clip and Adam a minibatch) and ``RMAPPOTrainer._train_body``
(``train``'s epochs, feed-forward and recurrent, with ValueNorm or PopArt)
run through ``tests/test_torch_graphs.py``'s ``CPUGraph``: the first call
eager (the warm-up), the capture running nothing (the parameters,
gradients, optimizer and ValueNorm state restored in place), then replays
on the static inputs, each checked to step the very tensors the capture
saw.  Chained updates, each against JAX's jitted update of the same
trajectories or buffers (and permutations), so that a replay reading stale
state or a stale input shows.

Tolerances, as ``tests/test_torch_train.py`` and ``tests/test_torch_mappo.py``
state them: self-play losses ``rtol 1e-4`` (``atol 1e-7``; Hanabi's loss
terms also within 1e-5), advantages and returns ``atol 1e-5``, parameter
deltas ``rtol 1e-4, atol 1e-7``; MAPPO's info ``rtol 1e-4, atol 1e-6``, the
ValueNorm statistics ``rtol 1e-5, atol 1e-7`` and parameter deltas ``rtol
1e-4, atol 1e-6``.  A load into a captured trainer against a fresh eager
trainer loaded from the same file: equal exactly (the same code on the same
inputs).  Also ``train/optim.py``'s optimizer helpers across devices, the
update's capture rule, and a dropped trainer's graphs collected before the
next capture (``torch.cuda``'s graph calls stubbed).
"""

import gc
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.core.types import StepOutput as JStepOutput
from madrona_rl_envs_playground_tpu.train import mappo as jm
from madrona_rl_envs_playground_tpu.train import selfplay as j_selfplay
from madrona_rl_envs_playground_tpu_torch.envs import overcooked as t_oc
from madrona_rl_envs_playground_tpu_torch.envs import overcooked2 as t_oc2
from madrona_rl_envs_playground_tpu_torch.models import mappo_nets as t_nets
from madrona_rl_envs_playground_tpu_torch.train import graphs
from madrona_rl_envs_playground_tpu_torch.train import mappo as tm
from madrona_rl_envs_playground_tpu_torch.train import optim as t_optim
from madrona_rl_envs_playground_tpu_torch.train import selfplay as t_selfplay
from madrona_rl_envs_playground_tpu_torch.train.mappo import runner as t_runner

from . import test_torch_mappo as ff_mappo
from . import test_torch_mappo_recurrent as rec_mappo
from .test_torch_graphs import CPUGraph, _hanabi_schedule, _np, stub_cuda  # noqa: F401
from .test_torch_hanabi import J_RESET
from .test_torch_hanabi_train import T as HT
from .test_torch_hanabi_train import _trainers as hanabi_trainers
from .test_torch_train import _trainers as cramped_trainers
from .test_torch_train import assert_deltas_match_jax

CPU = torch.device("cpu")
F32 = dict(atol=1e-5, rtol=0)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or F32))


# ---- self-play: the PPO epochs --------------------------------------------------

def _selfplay_case(name):
    """(JAX trainer, port trainer, three consecutive [T, N, P] action
    schedules)."""
    if name == "hanabi":
        jt, tt = hanabi_trainers()
        acts = _hanabi_schedule(3 * HT)
        return jt, tt, [acts[i * HT:(i + 1) * HT] for i in range(3)]
    # the JAX trainer's reset, jitted: eagerly it compiles op by op (~10 s)
    real = j_selfplay.batched_reset
    j_selfplay.batched_reset = lambda env, n, start=0: J_RESET(env, n, start)
    try:
        jt, tt = cramped_trainers()
    finally:
        j_selfplay.batched_reset = real
    rs = np.random.RandomState(9)
    acts = rs.choice(6, size=(24, 4, 2), p=[.15, .15, .15, .15, .05, .35]).astype(np.int32)
    return jt, tt, [acts[:8], acts[8:16], acts[16:]]


@pytest.mark.parametrize("name", ["cramped_room", "hanabi"])
def test_replayed_selfplay_updates_match_jax(name):
    """Three consecutive updates through the trainer's ``_update`` with the
    epochs' graph a ``CPUGraph`` (the warm-up, then two replays), each on
    the trainer's next rollout (injected actions, eager), against JAX's
    jitted ``_advantage`` and ``_update`` of the same trajectory, chained
    from the same start: advantages, returns, the last epoch's losses and
    every parameter delta.  Each replay returns the same static buffers and
    steps the parameters and Adam moments the previous update wrote in
    place."""
    jt, tt, schedules = _selfplay_case(name)
    tt._update_graph = CPUGraph(tt._update_body)
    advantage, update = jax.jit(jt._advantage), jax.jit(jt._update)
    params0, opt0 = jt.state["params"], jt.state["opt_state"]
    outputs = []
    for k, acts in enumerate(schedules):
        bstate, t_out, t_tr = tt._rollout(torch.from_numpy(acts))
        tt.state = {"bstate": bstate, "out": t_out}
        j_tr = {key: jnp.asarray(v.numpy()) for key, v in t_tr.items()}
        j_out = JStepOutput(**{f: jnp.asarray(getattr(t_out, f).numpy())
                               for f in JStepOutput.__dataclass_fields__})
        chunks, _ = advantage(params0, j_tr, j_out)
        params1, opt1, auxes = update(params0, opt0, chunks)

        before = {n: v.detach().clone() for n, v in tt.net.state_dict().items()}
        t_chunks, _ = tt._advantage(t_tr, t_out)
        _close(t_chunks["advantages"], chunks[5])
        _close(t_chunks["returns"], chunks[6])
        t_aux = tt._update(t_chunks)
        outputs.append(t_aux)
        for what, t_v, j_v in zip(("pg_loss", "v_loss", "entropy", "approx_kl"), t_aux, auxes):
            np.testing.assert_allclose(float(t_v), float(j_v[-1]), rtol=1e-4, atol=1e-7,
                                       err_msg=f"update {k} {what}")
            if name == "hanabi":
                assert abs(float(t_v) - float(j_v[-1])) <= 1e-5, what
        assert_deltas_match_jax(before, tt.net.state_dict(), params0, params1)
        params0, opt0 = params1, opt1
    assert tt._update_graph.graph is not None
    assert all(a is b for a, b in zip(outputs[1], outputs[2]))  # the static outputs
    assert int(next(iter(tt.opt.state.values()))["step"]) == 3 * 2 * 2  # updates x epochs x mbs


# ---- MAPPO: train ---------------------------------------------------------------

NORMS = {"valuenorm": {}, "popart": dict(use_popart=True, use_valuenorm=False),
         "lr_decay": dict(use_linear_lr_decay=True)}


def _mappo_trainers(recurrent, norm):
    """JAX's and the port's trainers from the same parameters, and their
    filled buffers (``tests/test_torch_mappo.py``'s, or
    ``tests/test_torch_mappo_recurrent.py``'s with the GRU and chunks of
    3), 2 epochs of 2 minibatches."""
    mod = rec_mappo if recurrent else ff_mappo
    kw = dict(episode_length=mod.T, n_rollout_threads=mod.N, hidden_size=16, layer_N=1,
              ppo_epoch=2, num_mini_batch=2, lr=1e-3, critic_lr=2e-3, seed=0, **NORMS[norm])
    shapes = ((24,), (24,), mod.ACT) if recurrent else ((mod.OBS,), (mod.SOBS,), mod.ACT)
    if recurrent:
        kw.update(use_recurrent_policy=True, data_chunk_length=3)
    j_pol = jm.MAPPOPolicy(jm.MAPPOConfig(**kw), *shapes, seed=0)
    j_tr = jm.RMAPPOTrainer(j_pol.cfg, j_pol)
    t_pol = tm.MAPPOPolicy(tm.MAPPOConfig(**kw), *shapes, seed=0, device=CPU)
    ps = j_tr.state.policy
    t_nets.load_mappo_params(t_pol.actor, t_pol.critic, _np(ps.actor_params),
                             _np(ps.critic_params))
    j_buf, t_buf = mod._filled_buffers(j_tr)
    return mod, j_tr, tm.RMAPPOTrainer(t_pol.cfg, t_pol), j_buf, t_buf


def _second_buffer(j_buf, t_buf):
    """Another episode for the second update: returns and value predictions
    moved, the rest kept."""
    ret, vp = np.asarray(j_buf.returns) * 0.7 + 0.3, np.asarray(j_buf.value_preds) - 0.2
    j2 = j_buf.replace(returns=jnp.asarray(ret), value_preds=jnp.asarray(vp))
    t2 = tm.MAPPOBuffer(**{f: getattr(t_buf, f).clone() for f in t_buf.__dataclass_fields__})
    t2.returns.copy_(torch.from_numpy(ret))
    t2.value_preds.copy_(torch.from_numpy(vp))
    return j2, t2


@pytest.mark.parametrize("recurrent", [False, True], ids=["ff", "gru"])
@pytest.mark.parametrize("norm", list(NORMS))
def test_replayed_mappo_train_matches_jax(recurrent, norm):
    """Two ``train``s through ``_train_body``'s ``CPUGraph`` (the warm-up,
    then a replay) on two buffers, with JAX's permutations as the graph's
    inputs, against JAX's jitted ``train`` chained from the same start:
    the info, the ValueNorm statistics and every parameter delta.  With
    ``use_linear_lr_decay`` the two updates take the decayed rates of
    episodes 0 and 1 of 2, filled in place into tensor rates (as ``adam``
    makes them on the card), against JAX's ``tree_set``."""
    mod, j_tr, t_tr, j_buf, t_buf = _mappo_trainers(recurrent, norm)
    bufs = [(j_buf, t_buf), _second_buffer(j_buf, t_buf)]
    pol = t_tr.policy
    if norm == "lr_decay":
        for opt in (pol.actor_opt, pol.critic_opt):
            for group in opt.param_groups:
                group["lr"] = torch.tensor(group["lr"], dtype=torch.float32)
    graph = CPUGraph(t_tr._train_body, [t_tr.generator])
    cfg = j_tr.cfg
    n = (mod.T // cfg.data_chunk_length if recurrent else mod.T) * mod.M  # chunks or samples
    j_state = j_tr.state
    for k, (jb, tb) in enumerate(bufs):
        lrs = pol.lr_for(k, 2)
        key = jax.random.PRNGKey(3 + k)
        perms = [torch.from_numpy(np.asarray(jax.random.permutation(e, n)).astype(np.int64))
                 for e in jax.random.split(key, cfg.ppo_epoch)]
        before = [{name: p.detach().clone() for name, p in m.named_parameters()}
                  for m in (pol.actor, pol.critic)]
        j_next, j_info = j_tr.train(j_state, jb, key, tuple(jnp.float32(x) for x in lrs))
        t_tr._set_lrs(lrs)
        t_info = graph(tb, perms)
        for name in ("value_loss", "policy_loss", "dist_entropy", "ratio"):
            np.testing.assert_allclose(float(t_info[name]), float(j_info[name]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"update {k} {name}")
        for f in ("running_mean", "running_mean_sq", "debiasing_term"):
            _close(getattr(t_tr.vn, f), getattr(j_next.vn, f), rtol=1e-5, atol=1e-7)
        j0, j1 = (mod._modules_from(pol, s.policy) for s in (j_state, j_next))
        for ours, b, m0, m1 in zip((pol.actor, pol.critic), before, j0, j1):
            for (name, p), p0, p1 in zip(ours.named_parameters(), m0.parameters(),
                                         m1.parameters()):
                np.testing.assert_allclose((p.detach() - b[name]).numpy(),
                                           (p1 - p0).detach().numpy(), rtol=1e-4, atol=1e-6,
                                           err_msg=f"update {k} {name}")
        j_state = j_next
    assert graph.graph is not None
    if norm == "lr_decay":
        assert float(pol.actor_opt.param_groups[0]["lr"]) == np.float32(5e-4)


# ---- load into a captured trainer -----------------------------------------------

def _captured_selfplay(monkeypatch, seed):
    monkeypatch.setattr(t_selfplay, "captures", lambda device, collector: True)
    monkeypatch.setattr(t_selfplay, "LoopGraph", CPUGraph)
    cfg = t_selfplay.SelfPlayConfig(num_steps=6, hidden=16, num_layers=1, update_epochs=2,
                                    num_minibatches=2)
    return t_selfplay.SelfPlayPPO(t_oc.make("cramped_room", horizon=6), 3, cfg, seed=seed,
                                  device="cpu")


def _ptrs(trainer):
    return [t.data_ptr() for t in trainer.update_state()]


def test_selfplay_load_into_a_captured_trainer(monkeypatch, tmp_path):
    """``load`` into a trainer whose rollout, scans and epochs replay
    graphs keeps the storage of every parameter, gradient and Adam tensor,
    and its next (replayed) update equals that of an uncaptured trainer of
    another seed loaded from the same file."""
    path = str(tmp_path / "sp.pt")
    a = _captured_selfplay(monkeypatch, seed=1)
    assert isinstance(a._update_graph, CPUGraph)
    a.train_step()
    a.train_step()
    a.save(path)
    ptrs = _ptrs(a)
    a.train_step()
    a.load(path)
    assert _ptrs(a) == ptrs
    got = {k: v.clone() for k, v in a.train_step().items()}
    monkeypatch.undo()
    b = t_selfplay.SelfPlayPPO(a.env, 3, a.cfg, seed=5, device="cpu")
    assert b._update_graph is None
    b.load(path)
    want = b.train_step()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for x, y in zip(a.update_state(), b.update_state(), strict=True):
        assert torch.equal(x, y)


def test_mappo_restore_into_a_captured_runner(monkeypatch, tmp_path):
    """``restore`` into a runner whose collect, returns and ``train``
    replay graphs keeps the storage of every parameter, gradient, optimizer
    and ValueNorm tensor, and its next update (collect and train replayed)
    equals that of an uncaptured runner restored from the same file with
    the same carry and generator states."""
    monkeypatch.setattr(t_runner, "captures", lambda device, collector: True)
    monkeypatch.setattr(t_runner, "LoopGraph", CPUGraph)
    monkeypatch.setattr(tm.trainer, "LoopGraph", CPUGraph)
    cfg = tm.MAPPOConfig(episode_length=6, n_rollout_threads=3, hidden_size=16, layer_N=1,
                         ppo_epoch=2, num_mini_batch=2, use_linear_lr_decay=True, seed=2)
    a = tm.MAPPORunner(cfg, t_oc2.make("cramped_room", horizon=5), device=CPU)
    assert a.trainer.captured and isinstance(a.trainer._train_graph, CPUGraph)
    a.update(0, 4)
    a.update(1, 4)
    a.save(str(tmp_path))
    ptrs = [t.data_ptr() for t in a.trainer.update_state()]
    carry = (a.bstate, a.out, a._masks.clone(), a._rnn.clone(), a._rnnc.clone())
    gens = (a.sample_gen.get_state(), a.trainer.generator.get_state())
    a.update(2, 4)
    a.restore(str(tmp_path))
    assert [t.data_ptr() for t in a.trainer.update_state()] == ptrs
    a.bstate, a.out, a._masks, a._rnn, a._rnnc = carry
    a.sample_gen.set_state(gens[0])
    a.trainer.generator.set_state(gens[1])
    got, got_rew = a.update(2, 4)
    got = {k: v.clone() for k, v in got.items()}
    monkeypatch.undo()
    b = tm.MAPPORunner(cfg, a.env, device=CPU)
    assert not b.trainer.captured
    b.restore(str(tmp_path))
    b.bstate, b.out, b._masks, b._rnn, b._rnnc = carry
    b.sample_gen.set_state(gens[0])
    b.trainer.generator.set_state(gens[1])
    want, want_rew = b.update(2, 4)
    assert got_rew == want_rew
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for x, y in zip(a.trainer.update_state(), b.trainer.update_state(), strict=True):
        assert torch.equal(x, y)


def test_optimizer_state_crosses_devices():
    """A state saved by the card's optimizer (``capturable``, a tensor
    learning rate, the step count a tensor) loads into a CPU optimizer,
    which keeps ``capturable=False`` and a float rate; into an optimizer
    that has stepped, in place.  ``adam`` on the CPU is torch's default
    Adam, AdamW where ``weight_decay`` is set, and ``set_lr`` fills a
    tensor rate in place."""
    net = torch.nn.Linear(3, 2)
    opt = t_optim.adam(net.parameters(), 1e-3, eps=1e-5)
    assert type(opt) is torch.optim.Adam and opt.param_groups[0]["capturable"] is False
    assert opt.param_groups[0]["lr"] == 1e-3
    assert type(t_optim.adam(net.parameters(), 1e-3, 1e-5, weight_decay=0.1)) is torch.optim.AdamW
    net(torch.ones(4, 3)).sum().backward()
    opt.step()
    saved = opt.state_dict()
    for group in saved["param_groups"]:
        group.update(capturable=True, lr=torch.tensor(2e-3))
    for st in saved["state"].values():
        st["exp_avg"] = st["exp_avg"] + 1.0
    held = t_optim.update_tensors([net], [opt])
    ptrs = [t.data_ptr() for t in held]
    t_optim.load_optimizer_state_(opt, saved)
    assert [t.data_ptr() for t in t_optim.update_tensors([net], [opt])] == ptrs
    group = opt.param_groups[0]
    assert group["capturable"] is False and group["lr"] == pytest.approx(2e-3)
    for p in net.parameters():
        assert opt.state[p]["step"].device.type == "cpu" and float(opt.state[p]["step"]) == 1
    fresh = t_optim.adam(torch.nn.Linear(3, 2).parameters(), 1e-3, eps=1e-5)
    t_optim.load_optimizer_state_(fresh, saved)
    assert all(float(st["step"]) == 1 for st in fresh.state.values())
    opt.step()  # capturable=False on the CPU: torch would refuse the other
    rate = torch.tensor(1e-3)
    tensor_opt = torch.optim.Adam(net.parameters(), lr=rate)
    t_optim.set_lr(tensor_opt, 5e-4)
    assert tensor_opt.param_groups[0]["lr"] is rate and float(rate) == np.float32(5e-4)


# ---- the capture rule -----------------------------------------------------------

def _stub_mesh():
    return types.SimpleNamespace(device=CPU, size=1, rows=lambda n: slice(0, n),
                                 local_size=lambda n: n, broadcast_module_=lambda m: None)


def test_update_capture_rule(monkeypatch):
    """Where the rollout is captured (a kernel collector on the card,
    stood in for by ``captures`` answering yes), the epochs are too, but
    not on a mesh, whose update all-reduces over gloo; a MAPPO trainer
    refuses a graph on a mesh.  On the CPU nothing is captured and the
    optimizers are torch's defaults (``capturable=False``, a float rate)."""
    env = t_oc.make("cramped_room", horizon=6)
    cfg = t_selfplay.SelfPlayConfig(num_steps=4, hidden=8, num_layers=1, update_epochs=1)
    cpu = t_selfplay.SelfPlayPPO(env, 2, cfg, device="cpu")
    assert not cpu.captured and cpu._update_graph is None
    assert cpu.opt.param_groups[0]["capturable"] is False
    mr = tm.MAPPORunner(tm.MAPPOConfig(episode_length=4, n_rollout_threads=2, hidden_size=8,
                                       layer_N=1, ppo_epoch=1), t_oc2.make("cramped_room"),
                        device=CPU)
    assert not mr.trainer.captured and mr.trainer._train_graph is None
    assert mr.policy.critic_opt.param_groups[0]["lr"] == mr.cfg.critic_lr

    monkeypatch.setattr(t_selfplay, "captures", lambda device, collector: True)
    monkeypatch.setattr(t_selfplay, "LoopGraph", CPUGraph)
    monkeypatch.setattr(t_selfplay, "put_selfplay_state", lambda state, mesh: state)
    assert isinstance(t_selfplay.SelfPlayPPO(env, 2, cfg, device="cpu")._update_graph, CPUGraph)
    meshed = t_selfplay.SelfPlayPPO(env, 2, cfg, device="cpu", mesh=_stub_mesh())
    assert meshed.captured and meshed._update_graph is None
    with pytest.raises(ValueError, match="mesh"):
        tm.RMAPPOTrainer(mr.cfg, mr.policy, mesh=_stub_mesh(), captured=True)


class _Owner:
    """A trainer's shape: it holds a graph of its own method (a cycle)."""

    def __init__(self):
        self.graph = graphs.LoopGraph(self.body)

    def body(self, x):
        return x + 1


def test_dropped_graphs_are_collected_before_a_capture(stub_cuda):
    """A dropped trainer's graphs (and so their memory pools) outlive it in
    a reference cycle; the next graph's first call collects them before its
    warm-up and capture, which ran the card short of memory after a few
    MAPPO runners without it."""
    gc.disable()
    try:
        dead = _Owner()
        dead.graph(torch.zeros(1))
        ref = weakref.ref(dead)
        del dead
        assert ref() is not None  # held by its cycle
        live = _Owner()
        live.graph(torch.zeros(1))
        assert ref() is None
    finally:
        gc.enable()
