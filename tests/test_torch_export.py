"""The port's browser and demo exports, the render path and the ASCII
visualizer against the JAX package's.

``utils/browser_export.py``: the op list of an actor equals JAX's from the
same flax parameters, exactly (both hold float32 weights as JSON floats);
``run_ops`` over it reproduces the port's actor's probabilities within 1e-5
(float64 interpretation of float32 products), as the test vector records
them.  ``utils/demo_export.py``: ``record_rollout``'s actions, rewards,
sparse states and obs digests equal JAX's on v1 and v2, and the pages
without an actor are byte for byte JAX's.  The JS assets are byte copies.
The CLIs run on the CPU: ``torch_export_browser.py`` and
``torch_export_demo.py`` on a ``checkpoint.pt`` beside JAX's CLIs on a
pickle of the same weights, ``torch_overcooked_visualizer.py`` beside JAX's
(its frames equal), ``torch_mappo_train.py --use_render``.
"""

import dataclasses
import json
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.envs import overcooked as j_oc1
from madrona_rl_envs_playground_tpu.envs import overcooked2 as j_oc2
from madrona_rl_envs_playground_tpu.models import mappo_nets as j_nets
from madrona_rl_envs_playground_tpu.utils import browser_export as j_be
from madrona_rl_envs_playground_tpu.utils import demo_export as j_de
from madrona_rl_envs_playground_tpu_torch.envs import overcooked as t_oc1
from madrona_rl_envs_playground_tpu_torch.envs import overcooked2 as t_oc2
from madrona_rl_envs_playground_tpu_torch.models import mappo_nets as t_nets
from madrona_rl_envs_playground_tpu_torch.utils import browser_export as t_be
from madrona_rl_envs_playground_tpu_torch.utils import demo_export as t_de
from madrona_rl_envs_playground_tpu_torch.utils.checkpoint import save_pytree

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import export_browser  # noqa: E402
import export_demo  # noqa: E402
import overcooked_visualizer  # noqa: E402
import torch_export_browser  # noqa: E402
import torch_export_demo  # noqa: E402
import torch_mappo_train  # noqa: E402
import torch_overcooked_visualizer  # noqa: E402

CPU = "cpu"


def _actors(seed=0, obs=9, hidden=24, layer_n=1, acts=5, relu=True, feature_norm=True):
    """A flax actor's parameters (perturbed, so that every LayerNorm is
    checked) and the port's actor holding them."""
    mc = j_nets.ModelConfig(hidden_size=hidden, layer_N=layer_n, use_relu=relu,
                            use_feature_normalization=feature_norm)
    j_actor = j_nets.R_Actor(mc, (obs,), acts)
    params = j_actor.init(jax.random.PRNGKey(seed), jnp.zeros((1, obs)),
                          jnp.zeros((1, 1, hidden)), jnp.ones((1,)))
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rs.randn(*x.shape)).astype(np.float32), params)
    tc = t_nets.ModelConfig(hidden_size=hidden, layer_N=layer_n, use_relu=relu,
                            use_feature_normalization=feature_norm)
    t_actor = t_nets.R_Actor(tc, (obs,), acts)
    t_critic = t_nets.R_Critic(tc, (obs,))
    cp = {"params": {"base": params["params"]["base"],
                     "v_out": {"kernel": np.zeros((hidden, 1), np.float32),
                               "bias": np.zeros((1,), np.float32)}}}
    t_nets.load_mappo_params(t_actor, t_critic, params, cp)
    return j_actor, params, mc, t_actor, tc


# ---- browser_export ------------------------------------------------------------------

@pytest.mark.parametrize("layer_n,relu,feature_norm", [(1, True, True), (2, False, True),
                                                       (1, True, False)])
def test_ops_equal_jax(layer_n, relu, feature_norm):
    _, params, mc, t_actor, tc = _actors(seed=layer_n, layer_n=layer_n, relu=relu,
                                         feature_norm=feature_norm)
    assert t_be.mappo_actor_to_ops(t_actor, tc, 5) == j_be.mappo_actor_to_ops(params, mc, 5)


def test_export_roundtrip_matches_actor(tmp_path):
    """JAX's ``test_export_roundtrip_matches_flax`` on the port: the bundle's
    four files, ``run_ops`` over model.json against the test vector and the
    actor's (and flax's) probabilities, illegal actions at ~0."""
    j_actor, params, _, t_actor, tc = _actors()
    obs = np.random.RandomState(4).randn(9).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0], bool)
    t_be.export_browser_bundle(str(tmp_path), t_actor, tc, 5, obs, mask, meta={"env": "unit"})
    for fname in ("model.json", "policy.js", "testvector.json", "demo.html"):
        assert (tmp_path / fname).exists(), fname
    assert (tmp_path / "policy.js").read_text() == j_be._POLICY_JS
    assert (tmp_path / "demo.html").read_text() == j_be._DEMO_HTML
    model = json.loads((tmp_path / "model.json").read_text())
    tv = json.loads((tmp_path / "testvector.json").read_text())
    assert tv["obs"] == obs.tolist() and tv["action_mask"] == mask.astype(int).tolist()
    probs = t_be.run_ops(model["ops"], np.asarray(tv["obs"]), np.asarray(tv["action_mask"], bool))
    np.testing.assert_allclose(probs, tv["expected_probs"], rtol=0, atol=1e-5)
    logits, _ = j_actor.apply(params, jnp.asarray(obs)[None], jnp.zeros((1, 1, 24)),
                              jnp.ones((1,)), jnp.asarray(mask)[None])
    np.testing.assert_allclose(probs, np.asarray(jax.nn.softmax(logits[0])), rtol=2e-4,
                               atol=1e-6)
    assert probs[2] < 1e-8 and probs[4] < 1e-8


def test_export_tanh_variant(tmp_path):
    _, _, _, t_actor, tc = _actors(seed=2, relu=False, layer_n=2)
    obs = np.linspace(-1, 1, 9).astype(np.float32)
    model = t_be.export_browser_bundle(str(tmp_path), t_actor, tc, 5, obs, None)
    with torch.no_grad():
        logits, _ = t_actor(torch.from_numpy(obs)[None], t_actor.zero_states(1), torch.ones(1))
        want = torch.softmax(logits[0].double(), -1).numpy()
    np.testing.assert_allclose(t_be.run_ops(model["ops"], obs, None), want, rtol=0, atol=1e-5)


def test_recurrent_actor_rejected(tmp_path):
    """A recurrent actor is refused, as JAX refuses it; so is a CNN one."""
    rec = t_nets.ModelConfig(hidden_size=8, use_recurrent_policy=True)
    with pytest.raises(ValueError, match="feed-forward"):
        t_be.export_browser_bundle(str(tmp_path), t_nets.R_Actor(rec, (4,), 2), rec, 2,
                                   np.zeros(4))
    with pytest.raises(ValueError):
        j_be.export_browser_bundle(str(tmp_path), {"params": {}},
                                   j_nets.ModelConfig(hidden_size=8, use_recurrent_policy=True),
                                   2, np.zeros(4))
    cnn = t_nets.ModelConfig(hidden_size=8)
    with pytest.raises(ValueError, match="conv"):
        t_be.mappo_actor_to_ops(t_nets.R_Actor(cnn, (4, 3, 2), 2), cnn, 2)
    assert not (tmp_path / "model.json").exists()


# ---- demo_export ---------------------------------------------------------------------

def _envs(variant, **kw):
    layout = "cramped_room" if variant == "v1" else "simple"
    j, t = (j_oc1, t_oc1) if variant == "v1" else (j_oc2, t_oc2)
    return j.make(layout, **kw), t.make(layout, **kw)


def test_js_assets_are_byte_copies():
    ours = REPO / "madrona_rl_envs_playground_tpu_torch" / "utils" / "demo_assets"
    theirs = REPO / "madrona_rl_envs_playground_tpu" / "utils" / "demo_assets"
    names = sorted(p.name for p in theirs.glob("*.js"))
    assert names == ["oc_env.js", "play_main.js", "render.js", "replay_main.js"]
    assert sorted(p.name for p in ours.glob("*.js")) == names
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_record_rollout_equals_jax(variant):
    """Random actions over 40 steps with a horizon of 15 (two resets): the
    actions, rewards, sparse states and obs digests, exactly."""
    j_env, t_env = _envs(variant, horizon=15)
    want = j_de.record_rollout(j_env, 40, seed=3, with_states=True)
    got = t_de.record_rollout(t_env, 40, seed=3, with_states=True, device=CPU)
    assert got == want
    assert 0 in [s["t"] for s in got["states"][1:]]


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_export_demo_bundle(tmp_path, variant):
    """JAX's ``test_export_demo_bundle`` on the port, and its pages and JSON
    files byte for byte JAX's."""
    j_env, env = _envs(variant, horizon=25)
    manifest = t_de.export_demo(str(tmp_path / "t"), env, num_vector_steps=55, seed=3,
                                device=CPU)
    assert manifest == {"outdir": str(tmp_path / "t"), "has_model": False,
                        "vector_steps": 55, "traj_steps": env.horizon}
    j_de.export_demo(str(tmp_path / "j"), j_env, num_vector_steps=55, seed=3)
    for name in ("play.html", "replay.html", "layout.json", "env_vectors.json", "traj.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name

    vectors = json.load(open(tmp_path / "t" / "env_vectors.json"))
    layout = json.load(open(tmp_path / "t" / "layout.json"))
    assert layout == t_de.env_config_json(env) and layout["variant"] == variant
    ts = [s["t"] for s in vectors["states"]]
    assert min(ts) >= 0 and max(ts) <= 25 and 0 in ts[1:]
    for st, dg in zip(vectors["states"], vectors["obs_digests"]):
        assert len(st["pos"]) == env.num_players and all(len(c) == 5 for c in st["cells"])
        assert len(dg) == env.num_players
    assert t_de.record_rollout(env, 55, seed=3, with_states=True, device=CPU) == vectors
    assert t_de._obs_digest(np.zeros(17, np.int8)) == 0
    assert t_de._obs_digest(np.ones(17, np.int8)) == sum((f % 97) + 1 for f in range(17))
    play = (tmp_path / "t" / "play.html").read_text()
    assert "function forward" in play and "runSelfCheck" in play and "class OcEnv" in play
    assert "fetch(" not in play and "http" not in play.split("</head>")[1]


def test_rollout_rewards_deterministic():
    env = t_oc1.make("cramped_room", horizon=25)
    rec = t_de.record_rollout(env, 40, seed=0, device=CPU)
    assert rec["rewards"] == t_de.record_rollout(env, 40, seed=0, device=CPU)["rewards"]


# ---- the CLIs --------------------------------------------------------------------------

def _checkpoints(tmp_path, env, hidden=16):
    """The same actor weights as JAX's pickle and as the port's
    checkpoint.pt."""
    _, params, _, t_actor, _ = _actors(seed=5, obs=env.obs_size, hidden=hidden, acts=6)
    pkl = tmp_path / "checkpoint.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"actor_params": params}, f)
    save_pytree(str(tmp_path / "run" / "checkpoint.pt"), {"actor_params": t_actor.state_dict()})
    return str(pkl), str(tmp_path / "run")


def _jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    return module.main()


def test_export_browser_cli_equals_jax(tmp_path, monkeypatch, capsys):
    env = t_oc2.make("simple")
    pkl, run = _checkpoints(tmp_path, env)
    _jax_main(export_browser, ["--checkpoint", pkl, "--hidden-size", "16",
                               "--out", str(tmp_path / "j")], monkeypatch)
    torch_export_browser.main(["--checkpoint", run, "--out", str(tmp_path / "t"),
                               "--device", CPU])
    assert capsys.readouterr().out.splitlines()[-1].startswith(f"wrote {tmp_path / 't'}/")
    assert (json.loads((tmp_path / "t" / "model.json").read_text())
            == json.loads((tmp_path / "j" / "model.json").read_text()))
    tv_t, tv_j = (json.loads((tmp_path / d / "testvector.json").read_text()) for d in "tj")
    assert tv_t["obs"] == tv_j["obs"] and tv_t["action_mask"] == tv_j["action_mask"]
    np.testing.assert_allclose(tv_t["expected_probs"], tv_j["expected_probs"], rtol=0,
                               atol=1e-5)


def test_export_demo_cli_equals_jax(tmp_path, monkeypatch):
    """With a checkpoint: the greedy actor's recorded play (through
    ``run_ops``) equals JAX's step for step, the replay page byte for byte."""
    env = t_oc1.make("cramped_room")
    pkl, run = _checkpoints(tmp_path, env)
    common = ["--layout", "cramped_room", "--horizon", "20", "--vector-steps", "30"]
    _jax_main(export_demo, common + ["--checkpoint", pkl, "--hidden-size", "16",
                                     "--out", str(tmp_path / "j")], monkeypatch)
    manifest = torch_export_demo.main(common + ["--checkpoint", run, "--device", CPU,
                                                "--out", str(tmp_path / "t")])
    assert manifest["has_model"] and manifest["traj_steps"] == 20
    for name in ("replay.html", "layout.json", "env_vectors.json", "traj.json",
                 "actor/model.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    traj = json.load(open(tmp_path / "t" / "traj.json"))
    assert len(set(map(tuple, traj["actions"]))) > 1  # the actor acts, not a constant


def test_export_refuses_a_recurrent_checkpoint(tmp_path):
    from madrona_rl_envs_playground_tpu_torch.train.mappo import MAPPOConfig, MAPPORunner

    cfg = MAPPOConfig(episode_length=4, n_rollout_threads=2, hidden_size=8, layer_N=1,
                      use_recurrent_policy=True, data_chunk_length=2)
    MAPPORunner(cfg, t_oc2.make("simple"), device=CPU).save(str(tmp_path))
    argv = ["--env", "overcooked2", "--layout", "simple", "--checkpoint", str(tmp_path),
            "--device", CPU, "--out", str(tmp_path / "out")]
    for cli in (torch_export_browser, torch_export_demo):
        with pytest.raises(ValueError, match="feed-forward"):
            cli.main(argv)


def test_checkpoint_carries_the_model_config(tmp_path):
    """``MAPPORunner.save`` stores the nets' ``ModelConfig``: a tanh run's
    actor is rebuilt as trained without ``--use-tanh``, and a contradicting
    activation is refused rather than exported as another policy."""
    from madrona_rl_envs_playground_tpu_torch.train.mappo import MAPPOConfig, MAPPORunner

    env = t_oc2.make("simple")
    cfg = MAPPOConfig(episode_length=4, n_rollout_threads=2, hidden_size=8, layer_N=2,
                      use_ReLU=False, use_feature_normalization=False)
    runner = MAPPORunner(cfg, env, device=CPU)
    runner.save(str(tmp_path))
    actor, mc = t_be.load_checkpoint_actor(str(tmp_path), env, device=CPU)
    assert mc == runner.policy.mc and not mc.use_relu
    obs = np.random.RandomState(3).randint(0, 2, size=env.obs_size)
    np.testing.assert_array_equal(t_be.actor_probs(actor, obs),
                                  t_be.actor_probs(runner.policy.actor, obs))
    assert t_be.load_checkpoint_actor(str(tmp_path), env, use_relu=False, device=CPU)[1] == mc
    with pytest.raises(ValueError, match="use_relu=False"):
        t_be.load_checkpoint_actor(str(tmp_path), env, use_relu=True, device=CPU)
    # a ReLU run refuses --use-tanh
    MAPPORunner(dataclasses.replace(cfg, use_ReLU=True), env, device=CPU).save(str(tmp_path))
    with pytest.raises(ValueError, match="use_relu=True"):
        torch_export_browser.main(["--env", "overcooked2", "--layout", "simple", "--checkpoint",
                                   str(tmp_path), "--use-tanh", "--device", CPU, "--out",
                                   str(tmp_path / "out")])


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_visualizer_frames_equal_jax(variant, monkeypatch, capsys):
    argv = ["--variant", variant, "--steps", "12", "--horizon", "8", "--seed", "2"]
    _jax_main(overcooked_visualizer, argv, monkeypatch)
    want = capsys.readouterr().out
    frames = torch_overcooked_visualizer.main(argv + ["--device", CPU])
    assert capsys.readouterr().out == want
    assert len(frames) == 13 and "\n\n".join(frames) + "\n" == want


def test_use_render_writes_the_replay_pages(tmp_path, capsys):
    """``torch_mappo_train.py --use_render`` on cramped_room: the pages over
    ``--render_episodes`` horizons, the actor bundle pinned to the trained
    actor."""
    run = str(tmp_path / "run")
    runner, _ = torch_mappo_train.main([
        "--over_layout", "cramped_room", "--episode_length", "10", "--n_rollout_threads", "4",
        "--hidden_size", "16", "--ppo_epoch", "1", "--num_env_steps", "40", "--device", CPU,
        "--run_dir", run, "--use_render", "--render_episodes", "1"])
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"render: wrote {run}/render/play.html and replay.html")
    render = tmp_path / "run" / "render"
    assert len(json.load(open(render / "traj.json"))["actions"]) == 10  # 1 x horizon
    tv = json.load(open(render / "actor" / "testvector.json"))
    probs = t_be.run_ops(json.load(open(render / "actor" / "model.json"))["ops"],
                         np.asarray(tv["obs"]), np.asarray(tv["action_mask"], bool))
    np.testing.assert_allclose(probs, tv["expected_probs"], rtol=0, atol=1e-5)
    assert tv["expected_probs"] == t_be.actor_probs(runner.policy.actor, tv["obs"],
                                                    tv["action_mask"]).tolist()
