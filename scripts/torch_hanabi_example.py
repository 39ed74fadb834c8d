#!/usr/bin/env python3
"""Hanabi benchmark/validation CLI on the port (counterpart of
``scripts/hanabi_example.py``; reference: scripts/hanabi_example.py).

    python3 scripts/torch_hanabi_example.py --num-steps 300 --validation \\
        --semantic --asserts
    python3 scripts/torch_hanabi_example.py --device cpu --num-envs 8 \\
        --num-steps 40 --validation --asserts

Each step every env plays a legal move of its seat to act, drawn on the host
(``run_masked_loop``).  ``--validation`` is three-way: the port's copies of
the sequential C++-derived oracle (``oracles/hanabi_rules.py``
``RecordingOracle``, also the hidden-draw recorder) and of the independent
HLE-semantics rules oracle (``RulesHanabi(cxx_quirks=True)``) against the
env, ending with ``Error rate: ...``; ``--semantic`` validates each step
from the exported tensors alone (``oracles/hanabi_decoder.py``).
``--isolated`` draws the legal moves on the device.  On the card every step
is one launch of the Hanabi step kernel (two players; more go through the
plain env).
"""

import time

import numpy as np
import torch

from torch_common import Stepper, base_parser, host_output, resolve_device, run_isolated, sync


def main(argv=None):
    p = base_parser(num_envs=32, num_steps=1000)
    p.add_argument("--config", default="full", choices=["full", "small", "very_small"])
    p.add_argument("--semantic", action="store_true",
                   help="per-step semantic validation from the exported "
                        "tensors alone (abstract step + mask rederivation + "
                        "cross-step equivalence — the analog of the "
                        "reference's HanabiState validate_step)")
    args = p.parse_args(argv)
    resolve_device(args.device)

    from madrona_rl_envs_playground_tpu_torch.envs.hanabi import CONFIGS, Env
    from madrona_rl_envs_playground_tpu_torch.oracles.hanabi import Counter
    from madrona_rl_envs_playground_tpu_torch.oracles.hanabi_rules import RulesHanabi

    cfg = CONFIGS[args.config]
    env = Env(**cfg)
    if args.isolated:
        # random legal actions drawn on the device keep turn-based stepping valid
        return run_isolated_hanabi(env, args.num_envs, args.num_steps, args.seed,
                                   device=args.device)

    validate = None
    if args.validation:
        # three-way: sequential C++-derived oracle (also the hidden-draw
        # recorder) + the independent HLE-semantics rules oracle
        from madrona_rl_envs_playground_tpu_torch.oracles.hanabi_rules import (
            RecordingOracle, draw_cursor)

        counter = Counter()
        oracles = [RecordingOracle(counter, **cfg) for _ in range(args.num_envs)]
        rules = [RulesHanabi(draw_cursor(o.drawn, env.ranks), cxx_quirks=True, **cfg)
                 for o in oracles]

        def validate(t, actions, out):
            bad = []
            for i, (o, g) in enumerate(zip(oracles, rules)):
                seat = o.cur
                ref_rew, ref_done = o.step(int(actions[i, seat]))
                g_rew, g_done = g.step(int(actions[i, seat]))
                ok = (ref_done == g_done == bool(out.done[i])
                      and np.all(out.reward[i] == np.float32(ref_rew))
                      and g_rew == ref_rew)
                if ok and not out.done[i]:
                    g_obs, g_state = g.encode(g.to_move)
                    ok = (np.array_equal(out.obs[i, g.to_move], g_obs)
                          and np.array_equal(out.state_obs[i, g.to_move], g_state)
                          and np.array_equal(out.action_mask[i, g.to_move],
                                             g.legal_mask(g.to_move)))
                if not ok:
                    bad.append(i)
            for o, g, d in zip(oracles, rules, out.done):
                if d:
                    o.reset()
                    g.new_game()
            return bad

    semantic = None
    if args.semantic:
        from madrona_rl_envs_playground_tpu_torch.oracles import hanabi_decoder as hv

        def semantic(prev_out, actions, out):
            hv.validate_step(env, prev_out, actions, out, out.done)

    # actions must be legal for the active seat: drive from the mask
    return run_masked_loop(env, args.num_envs, args.num_steps, args.seed, validate,
                           args.asserts, semantic, device=args.device)


def legal_draw(rs, out, players):
    """One legal move of each env's seat to act, uniform over its legal
    moves, from ``rs`` (host arrays ``out.action_mask``, ``out.active``);
    the other seats' actions are 0, which the env ignores."""
    N = out.active.shape[0]
    seat = out.active.argmax(1)
    legal = out.action_mask[np.arange(N), seat]
    k = (rs.random_sample(N) * legal.sum(1)).astype(np.int64)
    actions = np.zeros((N, players), np.int32)
    actions[np.arange(N), seat] = (np.cumsum(legal, 1) > k[:, None]).argmax(1)
    return actions


def run_masked_loop(env, num_envs, num_steps, seed, validate_fn, asserts,
                    semantic_fn=None, device=None):
    """JAX's masked loop: each step the host reads the legal moves and the
    seats to act, draws one move an env (vectorized; JAX draws env by env,
    so the streams differ) and steps.  The validators get numpy outputs;
    without them only the mask and the seats to act come to the host."""
    sim = Stepper(env, num_envs, device)
    rs = np.random.RandomState(seed)
    names = None if validate_fn or semantic_fn else ("action_mask", "active")
    out = host_output(sim.out, names)
    errors = checks = 0
    t0 = time.perf_counter()
    for t in range(num_steps):
        actions = legal_draw(rs, out, env.players)
        prev = out
        out = host_output(sim.step(actions), names)
        if semantic_fn is not None:
            semantic_fn(prev, actions, out)
        if validate_fn is not None:
            bad = validate_fn(t, actions, out)
            checks += 1
            if bad:
                errors += 1
                if asserts:
                    raise AssertionError(f"step {t}: envs {bad}")
    sync(sim.dev)
    dt = time.perf_counter() - t0
    sps = num_steps * num_envs / dt
    print(f"{sps:,.0f} step*worlds/sec")
    if validate_fn is not None:
        print(f"Error rate: {errors / max(checks, 1)}")
    return sps


def run_isolated_hanabi(env, num_envs, num_steps, seed, repeats=3, device=None):
    """``run_isolated`` with each seat's move drawn uniformly over its legal
    moves on the device; the inactive seats' moves are ignored by the env."""
    from madrona_rl_envs_playground_tpu_torch.models.common import (dist_sample,
                                                                    masked_categorical_logits)

    def draw(gen, out):
        zeros = torch.zeros(out.action_mask.shape, device=out.action_mask.device)
        return dist_sample(gen, masked_categorical_logits(zeros, out.action_mask))

    return run_isolated(env, num_envs, num_steps, seed, repeats, device=device, draw=draw)


if __name__ == "__main__":
    main()
