#!/usr/bin/env python3
"""Export the self-contained Overcooked browser demo (play.html and
replay.html) from the port, optionally with a trained MAPPO actor in the AI
seats (counterpart of ``scripts/export_demo.py``).

    python3 scripts/torch_export_demo.py --layout cramped_room --out demo_out
    python3 scripts/torch_export_demo.py --env overcooked2 --layout simple \\
        --checkpoint runs/mappo/checkpoint.pt --out demo_out

The rollouts step one world through the env's collector on ``--device``
(default the card: one K1 launch a step).  With a checkpoint
(``MAPPORunner.save``'s ``checkpoint.pt``, or its run directory; the actor
rebuilt from the config it stores, ``--use-tanh`` naming the activation of
one that stores none) the recorded
trajectories are the greedy actor's own play through ``run_ops``, the numpy
twin of policy.js, so that the replay matches what the browser's AI seat
does.  A recurrent or CNN actor is refused with ``ValueError``.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="overcooked", choices=["overcooked", "overcooked2"])
    p.add_argument("--layout", default="cramped_room")
    p.add_argument("--horizon", type=int, default=400)
    p.add_argument("--out", default="demo_out")
    p.add_argument("--vector-steps", type=int, default=120)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--use-tanh", action="store_true",
                   help="the activation of a checkpoint that stores no model config")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from madrona_rl_envs_playground_tpu_torch.envs import overcooked, overcooked2
    from madrona_rl_envs_playground_tpu_torch.utils.demo_export import export_demo

    env = (overcooked if args.env == "overcooked" else overcooked2).make(
        args.layout, horizon=args.horizon)

    actor = model_cfg = policy = None
    if args.checkpoint:
        from madrona_rl_envs_playground_tpu_torch.utils.browser_export import (
            load_checkpoint_actor, mappo_actor_to_ops, run_ops)

        actor, model_cfg = load_checkpoint_actor(
            args.checkpoint, env, use_relu=False if args.use_tanh else None, device=args.device)
        ops = mappo_actor_to_ops(actor, model_cfg, env.num_actions)

        def policy(obs, mask):
            n, pl, f = obs.shape
            x = obs.float().reshape(n * pl, f).cpu().numpy()
            probs = np.stack([run_ops(ops, row) for row in x])
            return np.argmax(probs, axis=-1).reshape(n, pl).astype(np.int32)

    manifest = export_demo(args.out, env, actor=actor, model_cfg=model_cfg, policy=policy,
                           num_vector_steps=args.vector_steps, seed=args.seed,
                           meta={"env": args.env, "layout": args.layout}, device=args.device)
    print(manifest)
    return manifest


if __name__ == "__main__":
    main()
