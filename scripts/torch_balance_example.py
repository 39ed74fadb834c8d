#!/usr/bin/env python3
"""Balance Beam benchmark/validation CLI on the port (counterpart of
``scripts/balance_example.py``; reference: scripts/balance_example.py).

    python3 scripts/torch_balance_example.py --validation --asserts
    python3 scripts/torch_balance_example.py --device cpu --num-envs 16 \\
        --num-steps 40 --validation --asserts

``--validation`` checks every step against the port's copy of the numpy
oracle (``oracles/balance_beam.py``, seat-major ``[2, N, 7]``) and ends with
``Error rate: ...``; ``--isolated`` times the loop with device-side actions.
On the card every step is one launch of the Balance Beam step kernel.
"""

import numpy as np

from torch_common import base_parser, resolve_device, run_isolated, run_timed_loop


def main(argv=None):
    args = base_parser(num_envs=32, num_steps=1000).parse_args(argv)
    resolve_device(args.device)
    from madrona_rl_envs_playground_tpu_torch.envs import balance_beam
    from madrona_rl_envs_playground_tpu_torch.oracles import balance_beam as oracle

    env = balance_beam.Env()
    if args.isolated:
        return run_isolated(env, args.num_envs, args.num_steps, args.seed, device=args.device)

    validate = None
    if args.validation:
        prev = {"obs": None}

        def validate(t, actions, out):
            obs = np.asarray(out.obs).transpose(1, 0, 2)  # [2, N, 7]
            rew = np.asarray(out.reward).T
            bad = []
            if prev["obs"] is not None:
                bad = oracle.validate_step(prev["obs"], actions.T, out.done, obs, rew)
            prev["obs"] = obs
            return bad

    return run_timed_loop(env, args.num_envs, args.num_steps, args.seed, validate,
                          args.asserts, device=args.device)


if __name__ == "__main__":
    main()
