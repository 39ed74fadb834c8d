"""Overcooked browser-demo exporter.

Counterpart of ``madrona_rl_envs_playground_tpu/utils/demo_export.py`` (the
reference's ``overcooked_demo/``: AI and human seats, trajectory replay) as
two self-contained HTML files, no server and no CDN:

* ``play.html``: the interactive game, each seat an exported actor
  (``policy.js`` over ``model.json``), the keyboard, random or stay.  On
  load it replays ``env_vectors`` (actions, sparse state dumps, rewards and
  obs digests recorded from the port's sim) through the bundled JS env and
  shows PASS or FAIL;
* ``replay.html``: scrubs a recorded trajectory by re-simulating it in the
  JS env, checking each step's reward.

The JS sources in ``demo_assets/`` are byte copies of the JAX package's
(``oc_env.js`` is the JS twin of ``envs/overcooked_base.py``; their text
names the JAX sim, which the port's equals); the page texts are JAX's.  The
exporter inlines the sources and the JSON data into each page.
``record_rollout`` steps one world through the env's collector
(``train/fused_collect.py``): on the card one K1 launch a step.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..core.batch import batched_reset
from ..device import DeviceLike, resolve_device
from ..train.fused_collect import make_fused_collect

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "demo_assets")

_PAGE = """\
<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>{title}</title>
<style>
  body {{ font-family: system-ui, sans-serif; background: #faf6ee;
         color: #2d2a26; margin: 24px; }}
  h2 {{ margin: 0 0 12px; }}
  .bar {{ margin: 10px 0; display: flex; gap: 14px; align-items: center;
          flex-wrap: wrap; }}
  canvas {{ border: 1px solid #d8cdb8; border-radius: 6px;
            background: #fffdf8; }}
  button {{ font-size: 15px; padding: 4px 14px; }}
  #selfcheck {{ white-space: pre-wrap; font-family: ui-monospace, monospace;
               font-size: 12px; padding: 8px; border-radius: 6px;
               max-width: 640px; }}
  #selfcheck.ok {{ background: #e4f2e4; }}
  #selfcheck.bad {{ background: #f6dcdc; }}
  .hint {{ color: #6b6257; font-size: 13px; }}
</style>
</head>
<body>
<h2>{title}</h2>
{body}
<script>const DEMO = {data_json};</script>
<script>{policy_js}</script>
<script>{env_js}</script>
<script>{render_js}</script>
<script>{main_js}</script>
</body>
</html>
"""

_PLAY_BODY = """\
<div class="bar">
  <span id="seats"></span>
  <label><input type="checkbox" id="greedy"> greedy</label>
  <label><input type="checkbox" id="loop" checked> loop episodes</label>
</div>
<div class="bar">
  <button id="playbtn" onclick="togglePlay()">Play</button>
  <button onclick="tick()">Step</button>
  <button onclick="resetGame()">Reset</button>
  <label>speed <input type="range" id="speed" min="1" max="30" value="6"></label>
</div>
<p class="hint">human seat: arrows move/turn, space interacts, "." stays</p>
<canvas id="game"></canvas>
<h3>Self-check (JS env vs JAX sim)</h3>
<div id="selfcheck">running...</div>
"""

_REPLAY_BODY = """\
<div class="bar">
  <button id="playbtn" onclick="togglePlay()">Play</button>
  <button onclick="stepOnce()">Step</button>
  <label>speed <input type="range" id="speed" min="1" max="30" value="8"></label>
</div>
<input type="range" id="stepSlider" min="0" value="0" style="width: 420px">
<div id="info"></div>
<canvas id="game"></canvas>
"""


def _read_asset(name: str) -> str:
    with open(os.path.join(_ASSET_DIR, name)) as f:
        return f.read()


def env_config_json(env) -> dict:
    """The env's static config in the layout.json schema oc_env.js consumes."""
    return {
        "variant": env.variant,
        "height": env.height,
        "width": env.width,
        "numPlayers": env.num_players,
        "terrain": list(env.terrain),
        "startPos": list(env.start_pos),
        "placementInPotRew": env.placement_in_pot_rew,
        "dishPickupRew": env.dish_pickup_rew,
        "soupPickupRew": env.soup_pickup_rew,
        "recipeValues": list(env.recipe_values),
        "recipeTimes": list(env.recipe_times),
        "horizon": env.horizon,
    }


def _obs_digest(obs: np.ndarray) -> int:
    """Order-weighted checksum; twin of OcEnv.obsDigest in oc_env.js."""
    f = np.arange(obs.size, dtype=np.int64)
    return int(np.sum(obs.astype(np.int64) * (f % 97 + 1)) % 1_000_000_007)


def _sparse_state(env, s, w: int) -> dict:
    """World w of a batched ``State`` -> the JS ``dumpState()`` schema."""
    g = lambda a: a[w].cpu().numpy()  # noqa: E731
    name = g(s.obj_name)
    onions, tomatoes, tick = g(s.obj_onions), g(s.obj_tomatoes), g(s.obj_tick)
    cells = [[int(i), int(name[i]), int(onions[i]), int(tomatoes[i]), int(tick[i])]
             for i in np.nonzero(name)[0]]
    return {
        "pos": g(s.pos).tolist(), "orient": g(s.orient).tolist(),
        "held": g(s.held_name).tolist(),
        "held_onions": g(s.held_onions).tolist(),
        "held_tomatoes": g(s.held_tomatoes).tolist(),
        "held_tick": g(s.held_tick).tolist(),
        "cells": cells, "t": int(s.timestep[w]),
    }


def record_rollout(env, num_steps: int, policy=None, seed: int = 0,
                   with_states: bool = False, device: DeviceLike = None) -> dict:
    """Roll one world of the port's sim on ``device`` (default the card)
    and record its actions and rewards (and, ``with_states``, each step's
    sparse state and obs digests for the JS self-check).

    ``policy(obs [1, P, F], mask [1, P, A]) -> actions [1, P]`` gets the
    step's tensors on ``device``; without one, actions are uniform random
    from ``numpy.random.RandomState(seed)``, JAX's draws."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    collect = make_fused_collect(env, 1, dev)
    bstate, out = batched_reset(env, 1, device=dev)
    carry = collect.pack(bstate)
    rec = {"actions": [], "rewards": []}
    if with_states:
        rec["states"], rec["obs_digests"] = [], []
    for _ in range(num_steps):
        if policy is None:
            actions = rs.randint(0, env.num_actions, size=(1, env.num_players))
        else:
            actions = policy(out.obs, out.action_mask)
        actions = np.asarray(torch.as_tensor(actions).cpu(), np.int32).reshape(1, -1)
        carry, out = collect.step(carry, torch.as_tensor(actions, device=dev))
        rec["actions"].append(actions[0].tolist())
        rec["rewards"].append(int(out.reward[0, 0]))
        if with_states:
            rec["states"].append(_sparse_state(env, collect.unpack(carry).env_states, 0))
            obs = out.obs[0].cpu().numpy()
            rec["obs_digests"].append([_obs_digest(obs[p]) for p in range(env.num_players)])
    return rec


def _render_page(title: str, body: str, main_js: str, data: dict) -> str:
    from .browser_export import _POLICY_JS

    return _PAGE.format(
        title=title, body=body,
        data_json=json.dumps(data),
        policy_js=_POLICY_JS.replace("export function", "function"),
        env_js=_read_asset("oc_env.js"),
        render_js=_read_asset("render.js"),
        main_js=main_js,
    )


def export_demo(outdir: str, env, actor=None, model_cfg=None, num_vector_steps: int = 120,
                num_traj_steps: Optional[int] = None, policy=None, seed: int = 0, meta=None,
                device: DeviceLike = None) -> dict:
    """Write play.html and replay.html (and the raw bundle files); the
    rollouts run on ``device`` (default the card).

    With ``actor`` (an ``R_Actor``) and ``model_cfg`` the AI seats run the
    exported actor (``actor/``, ``browser_export.export_browser_bundle``);
    without, the page still works with human and random seats.  Returns
    the manifest of what was written."""
    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    layout = env_config_json(env)
    vectors = record_rollout(env, num_vector_steps, policy=policy, seed=seed,
                             with_states=True, device=dev)
    traj = record_rollout(env, env.horizon if num_traj_steps is None else num_traj_steps,
                          policy=policy, seed=seed + 1, device=dev)

    model = testvector = None
    if actor is not None:
        from .browser_export import export_browser_bundle

        _, out = batched_reset(env, 1, device=dev)
        model = export_browser_bundle(
            os.path.join(outdir, "actor"), actor, model_cfg, env.num_actions,
            out.obs[0, 0].cpu().numpy(), out.action_mask[0, 0].cpu().numpy(), meta=meta)
        with open(os.path.join(outdir, "actor", "testvector.json")) as f:
            testvector = json.load(f)

    play_data = {"layout": layout, "vectors": vectors, "model": model,
                 "testvector": testvector}
    replay_data = {"layout": layout, "traj": traj}

    with open(os.path.join(outdir, "play.html"), "w") as f:
        f.write(_render_page("Overcooked — TPU-native demo", _PLAY_BODY,
                             _read_asset("play_main.js"), play_data))
    with open(os.path.join(outdir, "replay.html"), "w") as f:
        f.write(_render_page("Overcooked — trajectory replay", _REPLAY_BODY,
                             _read_asset("replay_main.js"), replay_data))
    for name, blob in (("layout.json", layout), ("env_vectors.json", vectors),
                       ("traj.json", traj)):
        with open(os.path.join(outdir, name), "w") as f:
            json.dump(blob, f)
    return {"outdir": outdir, "has_model": model is not None,
            "vector_steps": len(vectors["actions"]),
            "traj_steps": len(traj["actions"])}
