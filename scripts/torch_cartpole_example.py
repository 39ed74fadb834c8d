#!/usr/bin/env python3
"""Cartpole benchmark/validation CLI on the port (counterpart of
``scripts/cartpole_example.py``; reference: scripts/cartpole_example.py).

    python3 scripts/torch_cartpole_example.py --validation --asserts
    python3 scripts/torch_cartpole_example.py --device cpu --num-envs 32 \\
        --num-steps 60 --validation --asserts

``--validation`` checks every step against the port's copy of the numpy
oracle (``oracles/cartpole.py``) and ends with ``Error rate: ...``;
``--isolated`` times the loop with device-side actions.  On the card every
step is one launch of the Cartpole step kernel.
"""

from torch_common import base_parser, resolve_device, run_isolated, run_timed_loop


def main(argv=None):
    args = base_parser(num_envs=32, num_steps=1000).parse_args(argv)
    resolve_device(args.device)
    from madrona_rl_envs_playground_tpu_torch.envs import cartpole
    from madrona_rl_envs_playground_tpu_torch.oracles import cartpole as oracle

    env = cartpole.Env()
    if args.isolated:
        return run_isolated(env, args.num_envs, args.num_steps, args.seed, device=args.device)

    validate = None
    if args.validation:
        prev = {"obs": None}

        def validate(t, actions, out):
            obs = out.obs[:, 0]
            bad = []
            if prev["obs"] is not None:
                bad = oracle.validate_step(prev["obs"], actions[:, 0], out.done, obs)
            # re-sync on auto-reset (new episode state is not predictable
            # from the previous obs)
            prev["obs"] = obs
            return bad

    return run_timed_loop(env, args.num_envs, args.num_steps, args.seed, validate,
                          args.asserts, device=args.device)


if __name__ == "__main__":
    main()
