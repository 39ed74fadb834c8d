#!/usr/bin/env python3
"""Overcooked (modern multiplayer) benchmark/validation CLI on the port
(counterpart of ``scripts/overcooked_example.py``; reference:
scripts/overcooked_example.py).

    python3 scripts/torch_overcooked_example.py --validation --asserts
    python3 scripts/torch_overcooked_example.py --num-envs 8192 --num-steps 300 \\
        --horizon 100 --validation --native-validation --asserts
    python3 scripts/torch_overcooked_example.py --device cpu --num-envs 8 \\
        --num-steps 40 --horizon 30 --validation --asserts

``--validation`` checks every step against the port's copy of the Python
oracle (``oracles/overcooked.py``, one per env), with ``--native-validation``
against the batched C++ oracle (``oracles/native.py``, built with g++ into
``build/native/`` at first use); both end with ``Error rate: ...``.
``--use-native`` times the C++ oracle as the backend, ``--use-baseline`` and
``--use-async`` the Python oracles under ``SyncVectorEnv`` and
``AsyncVectorEnv``, ``--isolated`` the loop with device-side actions.  On the
card every step is one launch of the Overcooked step kernel.
"""

import time

import numpy as np

from torch_common import (base_parser, resolve_device, run_baseline_loop, run_isolated,
                          run_timed_loop)


def overcooked_main(variant: str, argv=None):
    p = base_parser(num_envs=32, num_steps=1000)
    p.add_argument("--layout", default="cramped_room" if variant == "v1" else "simple")
    p.add_argument("--horizon", type=int, default=400)
    p.add_argument("--num-players", type=int, default=None)
    p.add_argument("--native-validation", action="store_true",
                   help="validate against the C++ batched oracle (scales to "
                        "thousands of envs)")
    p.add_argument("--use-native", action="store_true",
                   help="run the C++ batched simulator as the backend "
                        "(alternate-backend perf comparison, the analog of "
                        "the reference's --use-taichi)")
    args = p.parse_args(argv)
    resolve_device(args.device)

    from madrona_rl_envs_playground_tpu_torch.envs import overcooked, overcooked2
    from madrona_rl_envs_playground_tpu_torch.envs.layouts import get_base_layout_params
    from madrona_rl_envs_playground_tpu_torch.oracles.overcooked import OvercookedOracle

    maker = overcooked.make if variant == "v1" else overcooked2.make
    env = maker(args.layout, horizon=args.horizon, num_players=args.num_players)
    params = get_base_layout_params(args.layout, args.horizon,
                                    max_num_players=args.num_players, variant=variant)
    if args.use_baseline or args.use_async:
        from madrona_rl_envs_playground_tpu_torch.oracles.adapters import OvercookedOracleEnv

        return run_baseline_loop(
            [lambda: OvercookedOracleEnv(variant, params) for _ in range(args.num_envs)],
            args.num_steps, args.seed, use_async=args.use_async, device=args.device,
        )
    if args.use_native:
        from madrona_rl_envs_playground_tpu_torch.oracles.native import NativeOvercookedOracle

        nat = NativeOvercookedOracle(variant, params, batch=args.num_envs)
        nat.reset()
        rs = np.random.RandomState(args.seed)
        acts = rs.randint(0, 6, size=(args.num_steps, args.num_envs,
                                      env.num_players)).astype(np.int32)
        nat.step(acts[0])  # warm
        t0 = time.perf_counter()
        for t in range(args.num_steps):
            nat.step(acts[t])
        dt = time.perf_counter() - t0
        sps = args.num_steps * args.num_envs / dt
        print(f"{sps:,.0f} step*worlds/sec (native C++ backend)")
        return sps
    if args.isolated:
        return run_isolated(env, args.num_envs, args.num_steps, args.seed, device=args.device)

    validate = None
    if args.validation and args.native_validation:
        # C++ batched oracle: whole-batch integer comparison per step, fast
        # enough to validate thousands of envs (oracles/native.py).
        from madrona_rl_envs_playground_tpu_torch.oracles.native import NativeOvercookedOracle

        nat = NativeOvercookedOracle(variant, params, batch=args.num_envs)
        nat.reset()

        def validate(t, actions, out):
            ref_obs, ref_rew, ref_done = nat.step(actions)
            bad = np.nonzero(
                (ref_done != out.done)
                | np.any(ref_rew[:, None] != out.reward, axis=1)
                | np.any(ref_obs != out.obs, axis=(1, 2))
            )[0]
            return bad.tolist()

    elif args.validation:
        oracles = [OvercookedOracle(variant, params) for _ in range(args.num_envs)]
        for o in oracles:
            o.reset()
        W, H, C = env.width, env.height, env.num_channels

        def validate(t, actions, out):
            obs = out.obs.reshape(args.num_envs, env.num_players, W, H, C)
            bad = []
            for i, o in enumerate(oracles):
                ref_obs, ref_rew, ref_done = o.step(actions[i])
                if ref_done:
                    ref_obs = o.reset()
                if (
                    ref_done != bool(out.done[i])
                    or not np.all(out.reward[i] == ref_rew)
                    or not np.array_equal(obs[i], ref_obs)
                ):
                    bad.append(i)
            return bad

    return run_timed_loop(env, args.num_envs, args.num_steps, args.seed, validate,
                          args.asserts, device=args.device)


def main(argv=None):
    return overcooked_main("v1", argv)


if __name__ == "__main__":
    main()
