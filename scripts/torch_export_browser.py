#!/usr/bin/env python3
"""Export a trained MAPPO actor to the browser bundle, on the port
(counterpart of ``scripts/export_browser.py``; the reference's
``train/torch_to_tfjs.py``).

Reads a ``torch_mappo_train.py`` run's ``checkpoint.pt`` (``MAPPORunner.save``)
and writes model.json, policy.js, testvector.json and demo.html: open
demo.html in a browser for its PASS/FAIL self-check, or load policy.js and
model.json from any JS front end.

    python3 scripts/torch_export_browser.py --checkpoint runs/mappo/checkpoint.pt \\
        --env overcooked2 --layout simple --out exported_actor/

The actor is rebuilt from the ``ModelConfig`` that ``MAPPORunner.save``
stores beside the parameters (JAX's CLI takes the width and depth as
``--hidden-size`` and ``--layer-N``).  A checkpoint of bare parameters has
its width, depth and feature LayerNorm read from their names, and
``--use-tanh`` names its activation, which leaves no parameter; on a stored
ReLU config ``--use-tanh`` is refused.  A recurrent or CNN actor is refused
with ``ValueError``.  The
test vector is a fresh episode's first observation and mask of seat 0, its
probabilities the actor's on ``--device`` (default the card).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_env(name, layout, num_players):
    from madrona_rl_envs_playground_tpu_torch.envs import (
        balance_beam, hanabi, overcooked, overcooked2)

    if name == "balance":
        return balance_beam.Env()
    if name == "hanabi":
        return hanabi.Env(**hanabi.CONFIGS["full"])
    if name == "overcooked":
        return overcooked.make(layout or "cramped_room", num_players=num_players)
    return overcooked2.make(layout or "simple", num_players=num_players)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True, help="checkpoint.pt, or the run directory")
    p.add_argument("--env", default="overcooked2",
                   choices=["balance", "hanabi", "overcooked", "overcooked2"])
    p.add_argument("--layout", default=None)
    p.add_argument("--num-players", type=int, default=None)
    p.add_argument("--use-tanh", action="store_true",
                   help="the activation of a checkpoint that stores no model config")
    p.add_argument("--out", default="exported_actor")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset
    from madrona_rl_envs_playground_tpu_torch.utils.browser_export import (
        export_browser_bundle, load_checkpoint_actor)

    env = make_env(args.env, args.layout, args.num_players)
    actor, mc = load_checkpoint_actor(args.checkpoint, env,
                                      use_relu=False if args.use_tanh else None,
                                      device=args.device)
    # test vector: a fresh episode's observation and mask for seat 0
    _, out = batched_reset(env, 1, device=args.device)
    obs = out.obs[0, 0].float().reshape(-1).cpu().numpy()
    mask = out.action_mask[0, 0].bool().reshape(-1).cpu().numpy()
    model = export_browser_bundle(
        args.out, actor, mc, env.num_actions, obs, mask,
        meta={"env": args.env, "layout": args.layout,
              "obs_size": int(env.obs_size), "num_actions": int(env.num_actions)})
    print(f"wrote {args.out}/model.json policy.js testvector.json demo.html")
    return model


if __name__ == "__main__":
    main()
