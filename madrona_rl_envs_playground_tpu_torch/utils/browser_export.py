"""Browser-loadable MAPPO actor export (the reference's ``torch_to_tfjs.py``
analog).

Counterpart of ``madrona_rl_envs_playground_tpu/utils/browser_export.py``:
the same self-contained bundle, read from the port's ``R_Actor`` module
where JAX reads flax parameters:

* ``model.json``: an op list (layernorm / dense / relu / tanh /
  masked_softmax) with inlined fp32 weights, in JAX's schema;
* ``policy.js``: the dependency-free ES module that interprets it (JAX's
  text);
* ``testvector.json``: an observation and action mask, and the action
  probabilities of the port's actor on them (its logits' softmax, computed
  on the actor's device);
* ``demo.html``: a static page that runs the JS forward on the test vector
  and reports PASS or FAIL (JAX's text).

``run_ops`` is the numpy twin of the JS interpreter, op for op.  Only the
feed-forward MLP actor exports: a recurrent actor raises ``ValueError``, as
JAX's export does; so does a CNN one, which the op list cannot express (JAX
fails there on a missing LayerNorm).  ``load_checkpoint_actor`` rebuilds
the actor of a ``MAPPORunner.save`` checkpoint (``checkpoint.pt``) from
the config it stores.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.mappo_nets import CNNBase, ModelConfig, R_Actor

MASK_NEG = -1e10  # keep in sync with models/mappo_nets.py


# ---------------------------------------------------------------------------
# op list from the actor module
# ---------------------------------------------------------------------------

def mappo_actor_to_ops(actor: R_Actor, model_cfg: ModelConfig, num_actions: int):
    """Op list for a feed-forward ``R_Actor`` (``MLPBase`` + ``ACTLayer``):
    the optional feature LayerNorm, then (1 + layer_N) x [dense -> act ->
    layernorm], then the head with illegal-logit masking and softmax (the
    reference's exported ``Policy`` ends in softmax, ``torch_to_tfjs.py:
    30-34``).  A dense op's kernel is ``[in, out]``, flax's layout."""
    if model_cfg.use_recurrent_policy or actor.rnn is not None:
        raise ValueError("browser export supports feed-forward actors only")
    if isinstance(actor.base, CNNBase):
        raise ValueError("browser export supports MLP actors only: the op list has no conv")
    if actor.act.linear.out_features != num_actions:
        raise ValueError(f"the actor has {actor.act.linear.out_features} actions, not "
                         f"{num_actions}")
    ops = []

    def host(t):
        return t.detach().float().cpu().numpy()

    def layernorm(norm):
        ops.append({"op": "layernorm", "scale": host(norm.weight).tolist(),
                    "bias": host(norm.bias).tolist(), "eps": norm.eps})

    def dense(lin):
        ops.append({"op": "dense", "kernel": host(lin.weight).T.tolist(),
                    "bias": host(lin.bias).tolist()})

    base = actor.base
    if base.feature_norm is not None:
        layernorm(base.feature_norm)
    for lin, norm in zip(base.layers, base.norms):
        dense(lin)
        ops.append({"op": "relu" if model_cfg.use_relu else "tanh"})
        layernorm(norm)
    dense(actor.act.linear)
    ops.append({"op": "masked_softmax", "mask_value": MASK_NEG})
    return ops


def run_ops(ops, x, mask=None):
    """Numpy interpreter for the op schema — the exact twin of policy.js."""
    x = np.asarray(x, np.float64)
    for op in ops:
        kind = op["op"]
        if kind == "layernorm":
            mu = x.mean(-1, keepdims=True)
            var = ((x - mu) ** 2).mean(-1, keepdims=True)
            x = (x - mu) / np.sqrt(var + op["eps"])
            x = x * np.asarray(op["scale"]) + np.asarray(op["bias"])
        elif kind == "dense":
            x = x @ np.asarray(op["kernel"]) + np.asarray(op["bias"])
        elif kind == "relu":
            x = np.maximum(x, 0.0)
        elif kind == "tanh":
            x = np.tanh(x)
        elif kind == "masked_softmax":
            if mask is not None:
                x = np.where(np.asarray(mask, bool), x, op["mask_value"])
            x = x - x.max(-1, keepdims=True)
            e = np.exp(x)
            x = e / e.sum(-1, keepdims=True)
        else:  # pragma: no cover
            raise ValueError(f"unknown op {kind}")
    return x


# ---------------------------------------------------------------------------
# bundle writer (JAX's texts)
# ---------------------------------------------------------------------------

_POLICY_JS = """\
// Dependency-free actor forward for the exported model.json op schema.
// Twin of run_ops() in utils/browser_export.py — keep the two in sync.
export function forward(model, obs, mask) {
  let x = Array.from(obs, Number);
  for (const op of model.ops) {
    if (op.op === "layernorm") {
      const n = x.length;
      const mu = x.reduce((a, b) => a + b, 0) / n;
      const va = x.reduce((a, b) => a + (b - mu) * (b - mu), 0) / n;
      const inv = 1.0 / Math.sqrt(va + op.eps);
      x = x.map((v, i) => (v - mu) * inv * op.scale[i] + op.bias[i]);
    } else if (op.op === "dense") {
      const out = op.bias.slice();
      for (let i = 0; i < x.length; i++) {
        const xi = x[i], row = op.kernel[i];
        for (let j = 0; j < out.length; j++) out[j] += xi * row[j];
      }
      x = out;
    } else if (op.op === "relu") {
      x = x.map((v) => Math.max(v, 0));
    } else if (op.op === "tanh") {
      x = x.map(Math.tanh);
    } else if (op.op === "masked_softmax") {
      if (mask) x = x.map((v, i) => (mask[i] ? v : op.mask_value));
      const m = Math.max(...x);
      const e = x.map((v) => Math.exp(v - m));
      const s = e.reduce((a, b) => a + b, 0);
      x = e.map((v) => v / s);
    } else {
      throw new Error("unknown op " + op.op);
    }
  }
  return x;
}

export function sampleGreedy(probs) {
  let best = 0;
  for (let i = 1; i < probs.length; i++) if (probs[i] > probs[best]) best = i;
  return best;
}
"""

_DEMO_HTML = """\
<!doctype html>
<html>
<head><meta charset="utf-8"><title>Actor self-check</title></head>
<body>
<h1>Exported actor self-check</h1>
<pre id="out">loading...</pre>
<script type="module">
import { forward } from "./policy.js";
const model = await (await fetch("./model.json")).json();
const tv = await (await fetch("./testvector.json")).json();
const probs = forward(model, tv.obs, tv.action_mask);
let maxerr = 0;
for (let i = 0; i < probs.length; i++)
  maxerr = Math.max(maxerr, Math.abs(probs[i] - tv.expected_probs[i]));
document.getElementById("out").textContent =
  (maxerr < 1e-4 ? "PASS" : "FAIL") +
  "  max |probs - expected| = " + maxerr.toExponential(3) +
  "\\nprobs = " + JSON.stringify(probs.map((p) => p.toFixed(6)));
</script>
</body>
</html>
"""


def actor_probs(actor: R_Actor, obs, mask=None) -> np.ndarray:
    """The actor's action probabilities on one observation (and mask), its
    logits' softmax on the actor's device, as float64."""
    dev = next(actor.parameters()).device
    with torch.no_grad():
        x = torch.as_tensor(np.asarray(obs, np.float32).reshape(1, -1), device=dev)
        m = None if mask is None else torch.as_tensor(np.asarray(mask, bool).reshape(1, -1),
                                                       device=dev)
        logits = actor(x, actor.zero_states(1, dev), torch.ones((1,), device=dev), m)[0][0]
        return torch.softmax(logits.double(), -1).cpu().numpy()


def export_browser_bundle(outdir: str, actor: R_Actor, model_cfg: ModelConfig,
                          num_actions: int, example_obs, example_mask=None, meta=None):
    """Write model.json, policy.js, testvector.json and demo.html; returns
    the model dict.  ``expected_probs`` in the test vector are the port's
    actor's, so the bundle is pinned to the network: ``run_ops`` over
    model.json must reproduce them (the tests, and ``chip_smoke.py`` on the
    card, within 1e-5), and the page checks the JS forward against them."""
    ops = mappo_actor_to_ops(actor, model_cfg, num_actions)
    os.makedirs(outdir, exist_ok=True)
    model = {"format": "mre-tpu-actor-v1", "num_actions": num_actions,
             "meta": meta or {}, "ops": ops}
    with open(os.path.join(outdir, "model.json"), "w") as f:
        json.dump(model, f)
    obs = np.asarray(example_obs, np.float32).reshape(-1)
    mask = None if example_mask is None else np.asarray(example_mask, bool).reshape(-1)
    tv = {
        "obs": obs.tolist(),
        "action_mask": None if mask is None else mask.astype(int).tolist(),
        "expected_probs": actor_probs(actor, obs, mask).tolist(),
    }
    with open(os.path.join(outdir, "testvector.json"), "w") as f:
        json.dump(tv, f)
    with open(os.path.join(outdir, "policy.js"), "w") as f:
        f.write(_POLICY_JS)
    with open(os.path.join(outdir, "demo.html"), "w") as f:
        f.write(_DEMO_HTML)
    return model


# ---------------------------------------------------------------------------
# MAPPORunner.save checkpoints
# ---------------------------------------------------------------------------

def _indices(sd, prefix: str, suffix: str):
    return sorted(int(k[len(prefix):-len(suffix)]) for k in sd
                  if k.startswith(prefix) and k.endswith(suffix))


def model_config_from_state_dict(sd, use_relu: bool = True) -> ModelConfig:
    """The ``ModelConfig`` of an actor's ``state_dict``: the width from the
    head, the depth and feature LayerNorm from the MLP base's names, the GRU
    cells from ``rnn.cells.<i>``.  The activation leaves no parameter, so
    the caller names it."""
    hidden = int(sd["act.linear.weight"].shape[1])
    layers = _indices(sd, "base.layers.", ".weight")
    cells = _indices(sd, "rnn.cells.", ".input.weight")
    return ModelConfig(hidden_size=hidden, layer_N=max(len(layers) - 1, 0), use_relu=use_relu,
                       use_feature_normalization="base.feature_norm.weight" in sd,
                       use_recurrent_policy=bool(cells), recurrent_N=max(len(cells), 1))


def load_checkpoint_actor(path: str, env, use_relu: Optional[bool] = None,
                          device: DeviceLike = None):
    """The actor of a ``MAPPORunner.save`` checkpoint (a directory holding
    ``checkpoint.pt``, or the file) for ``env``, on ``device`` (default the
    card), in eval mode; returns (actor, model config).  The config is the
    one the checkpoint stores; a checkpoint without one (bare parameters)
    has it read from the parameter names, with ``use_relu`` (default True)
    naming the activation.  A ``use_relu`` that contradicts the stored
    config raises ``ValueError``.  A conv base reads the env's grid,
    ``[width, height, num_channels]``."""
    from .checkpoint import load_pytree

    if os.path.isdir(path):
        path = os.path.join(path, "checkpoint.pt")
    blob = load_pytree(path)
    sd = blob["actor_params"] if "actor_params" in blob else blob
    if "model_config" in blob:
        mc = ModelConfig(**blob["model_config"])
        if use_relu is not None and use_relu != mc.use_relu:
            raise ValueError(f"{path} was trained with use_relu={mc.use_relu}; "
                             f"use_relu={use_relu} would rebuild another actor")
    else:
        mc = model_config_from_state_dict(sd, True if use_relu is None else use_relu)
    shape = ((env.width, env.height, env.num_channels) if "base.conv.weight" in sd
             else (env.obs_size,))
    actor = R_Actor(mc, shape, env.num_actions)
    actor.load_state_dict(sd)
    return actor.to(resolve_device(device)).eval(), mc
