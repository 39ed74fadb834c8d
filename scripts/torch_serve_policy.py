#!/usr/bin/env python3
"""Minimal policy inference server over a trained checkpoint, on the port
(counterpart of ``scripts/serve_policy.py``).

Loads a MAPPO checkpoint (``MAPPORunner.save``: ``<dir>/checkpoint.pt``) or a
self-play one (``SelfPlayPPO.save``) and serves actions over HTTP (stdlib
only).  The actor runs in fp32 on ``--device`` (default the card); no env is
stepped.  A recurrent or CNN MAPPO actor is named by the trainer's flags
(``--use_recurrent_policy``, ``--recurrent_N``, ``--use_cnn_obs``); a
recurrent one answers each request from a zero hidden state and masks of 1,
as JAX's server does.

    python3 scripts/torch_serve_policy.py --checkpoint runs/mappo \\
        --env_name overcooked --over_layout simple --port 8808

API (JAX's):
  GET  /health          -> {"ok": true, "env": ..., "obs_size": N, "num_actions": A}
  POST /act             body {"obs": [[...float/int...], ...],
                              "action_mask": [[...bool...], ...]?,
                              "deterministic": true?, "seed": int?}
                        -> {"actions": [int, ...]}
  A malformed request gets a 400 with {"error": ...}; the server keeps running.

Deterministic requests take the argmax of the logits; sampled ones draw
with ``models/common.dist_sample`` from a ``torch.Generator`` seeded with
the request's ``seed`` (not JAX's stream).  JAX pads each batch to a power
of two so that it can cache one compiled program per size; the port
compiles nothing and runs each batch at its own size.

``--env_name`` follows JAX's ``serve_policy.py``: ``overcooked`` is the v2
env and ``overcooked-new`` the v1 env (JAX's ``golden_trace.py`` maps them
the other way round; each module keeps its own mapping).
"""

import argparse
import json
import os
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def make_serve_env(args):
    """Env switch shared by the serving and eval CLIs: every trainable env
    family is servable (Hanabi's masked turn-based case and Cartpole
    included)."""
    from madrona_rl_envs_playground_tpu_torch.envs import (
        balance_beam, cartpole, hanabi, overcooked, overcooked2)

    if args.env_name == "overcooked":
        return overcooked2.make(args.over_layout, horizon=args.episode_length)
    if args.env_name == "overcooked-new":
        return overcooked.make(args.over_layout, horizon=args.episode_length)
    if args.env_name == "balance":
        return balance_beam.Env()
    if args.env_name == "hanabi":
        # over_layout doubles as the hanabi config name (full/small/very_small)
        cfg_name = args.over_layout if args.over_layout in hanabi.CONFIGS else "full"
        return hanabi.Env(**hanabi.CONFIGS[cfg_name])
    if args.env_name == "cartpole":
        return cartpole.Env()
    raise SystemExit(f"unknown env {args.env_name}")


def _actor_fn(logits_fn, env, dev):
    """``act(obs [B, F], mask [B, A] or None, seed, deterministic) ->
    actions [B]`` (numpy int32) over ``logits_fn(obs, mask)``."""
    from madrona_rl_envs_playground_tpu_torch.models.common import dist_sample

    def act(obs, mask, seed, deterministic):
        with torch.no_grad():
            obs_t = torch.as_tensor(np.asarray(obs, np.float32), device=dev)
            mask_t = (torch.ones((obs_t.shape[0], env.num_actions), dtype=torch.bool,
                                 device=dev) if mask is None
                      else torch.as_tensor(np.asarray(mask, bool), device=dev))
            logits = logits_fn(obs_t, mask_t)
            if deterministic:
                actions = torch.argmax(logits, -1).to(torch.int32)
            else:
                gen = torch.Generator(device=dev).manual_seed(int(seed))
                actions = dist_sample(gen, logits)
            return actions.cpu().numpy()

    return act


def load_actor(args):
    """Returns (act, env): ``act(obs, mask, seed, deterministic) ->
    actions``."""
    from madrona_rl_envs_playground_tpu_torch.device import resolve_device

    dev = resolve_device(getattr(args, "device", None))
    env = make_serve_env(args)
    if getattr(args, "agent", "mappo") == "selfplay":
        return _load_selfplay_actor(args, env, dev), env

    from madrona_rl_envs_playground_tpu_torch.train.mappo import MAPPOConfig, MAPPORunner

    cfg = MAPPOConfig(hidden_size=args.hidden_size, layer_N=args.layer_N,
                      episode_length=args.episode_length, n_rollout_threads=1,
                      **{k: getattr(args, k, v) for k, v in NET_FLAGS.items()})
    runner = MAPPORunner(cfg, env, device=dev)
    runner.restore(args.checkpoint)
    actor = runner.policy.actor.eval()

    def logits(obs, mask):
        # each request from a zero hidden state and masks of 1 (JAX's
        # serve_policy.py); a feed-forward actor passes the states through
        B = obs.shape[0]
        return actor(obs, actor.zero_states(B, dev), torch.ones((B,), device=dev), mask)[0]

    return _actor_fn(logits, env, dev), env


# the MAPPO flags that shape the actor beyond its width and depth, with
# torch_mappo_train.py's names and defaults
NET_FLAGS = {"use_recurrent_policy": False, "use_naive_recurrent_policy": False,
             "recurrent_N": 1, "use_cnn_obs": False}


def add_net_flags(p: argparse.ArgumentParser) -> None:
    for name, default in NET_FLAGS.items():
        if isinstance(default, bool):
            p.add_argument(f"--{name}", action="store_true")
        else:
            p.add_argument(f"--{name}", type=type(default), default=default)


def _load_selfplay_actor(args, env, dev):
    """Actor forward over a ``SelfPlayPPO.save`` checkpoint (``{"net":
    state_dict, ...}``).  Only the actor tower runs; the posted action mask
    is applied inside the masked categorical head (Hanabi's turn-based
    legal-move case).  The width and depth come from the actor tower's
    weights, so the CLI's MAPPO-sized flags cannot mismatch the
    checkpoint; the net serves in fp32 whatever it trained in."""
    from madrona_rl_envs_playground_tpu_torch.models.cleanrl import CleanRLNetwork
    from madrona_rl_envs_playground_tpu_torch.utils.checkpoint import load_pytree

    sd = load_pytree(args.checkpoint)["net"]
    layers = sorted(int(k.split(".")[2]) for k in sd
                    if k.startswith("actor.layers.") and k.endswith(".weight"))
    hidden, num_layers = int(sd["actor.layers.0.weight"].shape[0]), len(layers) - 1
    net = CleanRLNetwork(env.obs_size, env.num_actions, hidden, num_layers,
                         state_size=int(sd["critic.layers.0.weight"].shape[1]))
    net.load_state_dict(sd)
    net = net.to(dev).eval()
    return _actor_fn(net.get_logits, env, dev)


def make_handler(act, env):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"ok": True, "env": type(env).__name__,
                                 "obs_size": env.obs_size,
                                 "num_actions": env.num_actions})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/act":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                obs = np.asarray(req["obs"], np.float32)
                if obs.ndim == 1:
                    obs = obs[None]
                if obs.shape[-1] != env.obs_size:
                    raise ValueError(f"obs width {obs.shape[-1]} != {env.obs_size}")
                mask = req.get("action_mask")
                mask = None if mask is None else np.asarray(mask, bool)
                if mask is not None and mask.shape != (obs.shape[0], env.num_actions):
                    raise ValueError(f"action_mask shape {mask.shape} != "
                                     f"{(obs.shape[0], env.num_actions)}")
                actions = act(obs, mask, int(req.get("seed", 0)),
                              bool(req.get("deterministic", True)))
                self._json(200, {"actions": actions.tolist()})
            except Exception as e:  # report, don't crash the server
                self._json(400, {"error": str(e)})

    return Handler


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--agent", default="mappo", choices=["mappo", "selfplay"],
                   help="checkpoint flavor: a MAPPORunner.save dir, or a "
                        "SelfPlayPPO.save file")
    p.add_argument("--env_name", default="overcooked",
                   choices=["overcooked", "overcooked-new", "balance", "hanabi", "cartpole"])
    p.add_argument("--over_layout", default="simple")
    p.add_argument("--episode_length", type=int, default=200)
    p.add_argument("--hidden_size", type=int, default=64)
    p.add_argument("--layer_N", type=int, default=1)
    add_net_flags(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8808)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    act, env = load_actor(args)
    act(np.zeros((1, env.obs_size), np.float32), None, 0, True)  # warm the first call
    server = ThreadingHTTPServer((args.host, args.port), make_handler(act, env))
    print(f"serving {args.env_name}/{args.over_layout} policy on "
          f"http://{args.host}:{server.server_address[1]}  (POST /act, GET /health)",
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
