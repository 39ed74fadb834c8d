"""The port's policy server (``scripts/torch_serve_policy.py``) on the CPU.

The three tests of ``tests/test_serve_policy.py`` on the port (a MAPPO
Balance Beam checkpoint served over HTTP, equal to a direct deterministic
forward, a malformed request answered 400 with the server still up; a
self-play Hanabi checkpoint whose masked answers are legal and equal to a
direct forward; Cartpole through the serve and tester paths), then against
the JAX package's server on the same weights: a JAX MAPPO runner trained
for one episode, carried into the port with ``load_mappo_params``, and a
JAX self-play Hanabi actor, carried with ``load_flax_params``.  The port's
deterministic answers must equal JAX's ``serve_policy.load_actor``'s on the
same obs (and masks), exactly: argmax of fp32 logits.  Sampled answers are
not compared (the streams differ).
"""

import json
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import serve_policy  # noqa: E402
import torch_serve_policy  # noqa: E402
import torch_tester  # noqa: E402

from madrona_rl_envs_playground_tpu_torch.envs import balance_beam, hanabi  # noqa: E402
from madrona_rl_envs_playground_tpu_torch.models.cleanrl import (  # noqa: E402
    CleanRLNetwork, load_flax_params)
from madrona_rl_envs_playground_tpu_torch.models.mappo_nets import load_mappo_params  # noqa: E402
from madrona_rl_envs_playground_tpu_torch.train.mappo import (  # noqa: E402
    MAPPOConfig, MAPPORunner)
from madrona_rl_envs_playground_tpu_torch.train.selfplay import (  # noqa: E402
    SelfPlayConfig, SelfPlayPPO)

CPU = "cpu"


def _args(**kw):
    base = dict(agent="mappo", over_layout="simple", episode_length=6, hidden_size=16,
                layer_N=1, device=CPU)
    return type("Args", (), dict(base, **kw))


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/act",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _serve(act, env):
    server = ThreadingHTTPServer(("127.0.0.1", 0), torch_serve_policy.make_handler(act, env))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def test_serve_roundtrip(tmp_path):
    cfg = MAPPOConfig(episode_length=6, n_rollout_threads=4, hidden_size=16, layer_N=1,
                      ppo_epoch=1)
    runner = MAPPORunner(cfg, balance_beam.Env(), device=CPU)
    runner.run(episodes=1, log=None)
    ck = str(tmp_path / "ck")
    runner.save(ck)

    act, env = torch_serve_policy.load_actor(_args(checkpoint=ck, env_name="balance"))
    server, port = _serve(act, env)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as r:
            health = json.loads(r.read())
        assert health == {"ok": True, "env": "Env", "obs_size": env.obs_size,
                          "num_actions": env.num_actions}

        obs = np.random.RandomState(0).randint(0, 3, size=(3, env.obs_size)).astype(float)
        served = _post(port, {"obs": obs.tolist()})["actions"]
        with torch.no_grad():  # direct deterministic forward
            actor = runner.policy.actor
            logits, _ = actor(torch.as_tensor(obs, dtype=torch.float32), actor.zero_states(3),
                              torch.ones(3), torch.ones((3, env.num_actions), dtype=torch.bool))
        np.testing.assert_array_equal(served, torch.argmax(logits, -1).numpy())

        # 8 concurrent clients get the serial answers
        batches = [np.random.RandomState(s).randint(0, 3, size=(1 + s, env.obs_size)).tolist()
                   for s in range(8)]
        serial = [_post(port, {"obs": b}) for b in batches]
        with ThreadPoolExecutor(8) as pool:
            assert list(pool.map(lambda b: _post(port, {"obs": b}), batches)) == serial
        # a sampled request is reproducible by its seed and lies in range
        a1 = _post(port, {"obs": obs.tolist(), "deterministic": False, "seed": 5})
        assert a1 == _post(port, {"obs": obs.tolist(), "deterministic": False, "seed": 5})
        assert all(0 <= a < env.num_actions for a in a1["actions"])

        # malformed request -> 400, server stays alive
        for bad in ({"obs": [[1.0, 2.0]]}, {"nothing": 1},
                    {"obs": obs.tolist(), "action_mask": [[True]]}):
            try:
                _post(port, bad)
                raise AssertionError("expected HTTP 400")
            except urllib.error.HTTPError as e:
                assert e.code == 400 and "error" in json.loads(e.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as r:
            assert json.loads(r.read())["ok"]
    finally:
        server.shutdown()


def test_serve_selfplay_hanabi_masked(tmp_path):
    """The turn-based masked case: a SelfPlayPPO Hanabi checkpoint serves
    actions that match a direct masked forward and never break the posted
    legal-move mask; width and depth come from the checkpoint."""
    env = hanabi.Env(**hanabi.CONFIGS["very_small"])
    cfg = SelfPlayConfig(num_steps=8, hidden=32, num_layers=2)
    ppo = SelfPlayPPO(env, 4, cfg, seed=0, device=CPU)
    ppo.train_step()
    ck = str(tmp_path / "hanabi.ckpt")
    ppo.save(ck, with_env_state=False)

    act, senv = torch_serve_policy.load_actor(_args(
        checkpoint=ck, agent="selfplay", env_name="hanabi", over_layout="very_small",
        episode_length=200, hidden_size=999, layer_N=9))  # wrong on purpose: inferred
    assert senv.num_actions == env.num_actions

    rs = np.random.RandomState(0)
    obs = rs.randint(0, 2, size=(5, env.obs_size)).astype(np.float32)
    mask = np.zeros((5, env.num_actions), bool)
    legal = rs.randint(0, env.num_actions, size=(5, 3))
    for i in range(5):
        mask[i, legal[i]] = True
    served = act(obs, mask, 0, True)
    assert all(mask[i, served[i]] for i in range(5))
    with torch.no_grad():
        logits = ppo.net.get_logits(torch.as_tensor(obs), torch.as_tensor(mask))
    np.testing.assert_array_equal(served, torch.argmax(logits, -1).numpy())
    sampled = act(obs, mask, 3, False)
    assert all(mask[i, sampled[i]] for i in range(5))


def test_serve_and_tester_cartpole(tmp_path, capsys):
    """Cartpole through the MAPPO serve and eval paths."""
    args = _args(env_name="cartpole")
    env = torch_serve_policy.make_serve_env(args)
    cfg = MAPPOConfig(episode_length=6, n_rollout_threads=4, hidden_size=16, layer_N=1,
                      ppo_epoch=1)
    runner = MAPPORunner(cfg, env, device=CPU)
    runner.run(episodes=1, log=None)
    ck = str(tmp_path / "cp")
    runner.save(ck)

    args.checkpoint = ck
    act, senv = torch_serve_policy.load_actor(args)
    out = act(np.zeros((2, senv.obs_size), np.float32), None, 0, True)
    assert out.shape == (2,) and all(0 <= a < senv.num_actions for a in out)
    score = torch_tester.main(["--model_dir", ck, "--env_name", "cartpole", "--episode_length",
                               "6", "--n_rollout_threads", "4", "--hidden_size", "16",
                               "--device", CPU])
    r2 = MAPPORunner(cfg, env, device=CPU)
    r2.restore(ck)
    assert np.isfinite(score) and score == r2.evaluate(episodes=1, deterministic=True)
    assert capsys.readouterr().out.splitlines()[-1] == f"average episode score: {score:.3f}"


def test_port_server_answers_jax_mappo_actions(tmp_path):
    """JAX's MAPPO runner, one episode on Balance Beam; its weights carried
    into a port runner, saved, and served: the same deterministic actions as
    JAX's server on the same obs."""
    from madrona_rl_envs_playground_tpu.envs import balance_beam as jbalance
    from madrona_rl_envs_playground_tpu.train.mappo import MAPPOConfig as JConfig
    from madrona_rl_envs_playground_tpu.train.mappo import MAPPORunner as JRunner

    kw = dict(episode_length=6, n_rollout_threads=4, hidden_size=16, layer_N=1, ppo_epoch=1)
    jr = JRunner(JConfig(**kw), jbalance.Env())
    jr.run(episodes=1)
    jck = str(tmp_path / "jax")
    jr.save(jck)
    args = _args(checkpoint=jck, env_name="balance")
    j_act, env = serve_policy.load_actor(args)

    tr = MAPPORunner(MAPPOConfig(**kw), balance_beam.Env(), device=CPU)
    pol = jr.trainer.state.policy
    load_mappo_params(tr.policy.actor, tr.policy.critic, pol.actor_params, pol.critic_params)
    tck = str(tmp_path / "port")
    tr.save(tck)
    args.checkpoint = tck
    t_act, _ = torch_serve_policy.load_actor(args)

    obs = np.random.RandomState(1).randint(-2, 7, size=(64, env.obs_size)).astype(np.float32)
    want = j_act(obs, None, 0, True)
    assert len(set(want.tolist())) > 1
    np.testing.assert_array_equal(t_act(obs, None, 0, True), want)
    mask = np.random.RandomState(2).rand(64, env.num_actions) < 0.6
    mask[:, 0] = True
    np.testing.assert_array_equal(t_act(obs, mask, 0, True), j_act(obs, mask, 0, True))


def test_port_server_answers_jax_selfplay_hanabi_actions(tmp_path):
    """A JAX self-play Hanabi checkpoint (one update) and the same weights
    in a port checkpoint (``load_flax_params``): equal masked deterministic
    answers, every one legal."""
    from madrona_rl_envs_playground_tpu.envs import hanabi as jhanabi
    from madrona_rl_envs_playground_tpu.train.selfplay import SelfPlayConfig as JConfig
    from madrona_rl_envs_playground_tpu.train.selfplay import SelfPlayPPO as JPPO

    jenv = jhanabi.Env(**jhanabi.CONFIGS["very_small"])
    jppo = JPPO(jenv, 4, JConfig(num_steps=8, hidden=32, num_layers=2, rollout_backend="jnp"),
                seed=0)
    jppo.state, _ = jppo.train_step(jppo.state)
    jck = str(tmp_path / "jax.ckpt")
    jppo.save(jck, with_env_state=False)
    args = _args(checkpoint=jck, agent="selfplay", env_name="hanabi", over_layout="very_small",
                 episode_length=200)
    j_act, env = serve_policy.load_actor(args)

    tppo = SelfPlayPPO(hanabi.Env(**hanabi.CONFIGS["very_small"]), 4,
                       SelfPlayConfig(num_steps=8, hidden=32, num_layers=2), seed=0, device=CPU)
    load_flax_params(tppo.net, jppo.state["params"])
    tck = str(tmp_path / "port.ckpt")
    tppo.save(tck, with_env_state=False)
    args.checkpoint = tck
    t_act, _ = torch_serve_policy.load_actor(args)
    assert isinstance(tppo.net, CleanRLNetwork)

    rs = np.random.RandomState(3)
    obs = rs.randint(0, 2, size=(64, env.obs_size)).astype(np.float32)
    mask = rs.rand(64, env.num_actions) < 0.3
    mask[np.arange(64), rs.randint(0, env.num_actions, 64)] = True
    got = t_act(obs, mask, 0, True)
    np.testing.assert_array_equal(got, j_act(obs, mask, 0, True))
    assert mask[np.arange(64), got].all()
