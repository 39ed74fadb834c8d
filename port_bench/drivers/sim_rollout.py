"""Traffic ``sim_rollout``: the batch simulator alone through K2
(``ops/overcooked.py`` ``fused_rollout``), launch after launch.

Each launch steps ``num_envs`` worlds ``num_steps`` times with actions from
the per-(world, player) LCG words (``init_action_rng`` seeded from
``--seed``), chained on the state and words the launch before returned;
the host consumes each launch's done counts and checksums (their int32
total, read back), as the bench line's rollout route does, which also
closes the loop.  The first launch (set-up: it loads the kernel) and
``warm_launches`` more go before the window.  The judge holds
``check_worlds`` worlds drawn from the seed against the frozen plain env
on three launches: the first, from the plain env's own fresh state and
action words, and two in the window (one drawn from the seed, and the
last), from the program's state and words at their start.
"""

from __future__ import annotations

import time

import torch

from port_bench import common
from port_bench.reference import overcooked as ref_env

FIELDS = ("rows", "timestep", "w", "dcnt", "chk")


def consume(dcnt: torch.Tensor, chk: torch.Tensor) -> int:
    """The launch's done counts and checksums, totalled and read back."""
    return int(chk.sum(dtype=torch.int64) + dcnt.sum(dtype=torch.int64))


def columns(idx, ts, w, out=None) -> dict:
    """The sampled worlds' columns of a launch's inputs (and outputs)."""
    got = {"in": (ts.rows[:, idx].clone(), ts.timestep[idx].clone(), w[:, idx].clone())}
    if out is not None:
        ts2, w2, dcnt, chk = out
        got["out"] = dict(rows=ts2.rows[:, idx].clone(), timestep=ts2.timestep[idx].clone(),
                          w=w2[:, idx].clone(), dcnt=dcnt[idx].clone(), chk=chk[idx].clone())
    return got


def run(ctx: common.Context) -> common.Result:
    from madrona_rl_envs_playground_tpu_torch.envs import overcooked as oc_envs
    from madrona_rl_envs_playground_tpu_torch.ops import overcooked as ok

    rollout = ok.fused_rollout
    c, tf, dev = ctx.config, ctx.traffic, ctx.device
    env = oc_envs.make(c["layout_name"], horizon=c["horizon"])
    N, T = tf["num_envs"], tf["num_steps"]
    gen = torch.Generator().manual_seed(ctx.seed)
    idx = torch.randperm(N, generator=gen)[:tf["check_worlds"]].to(dev)
    # the window launch checked besides the last, drawn from the launches
    # every run reaches
    drawn = int(torch.randint(0, tf["min_window_launches"], (1,), generator=gen))

    ts = ok.init_packed(env, N, device=dev)
    w = ok.init_action_rng(N, env.num_agents, seed=ctx.seed, device=dev)
    out = rollout(env, ts, w, T)
    consume(out[2], out[3])
    first = columns(idx, ts, w, out)
    first["idx"] = idx
    ts, w = out[0], out[1]
    for _ in range(tf["warm_launches"]):
        ts, w, dcnt, chk = rollout(env, ts, w, T)
        consume(dcnt, chk)
    common.sync(dev)

    launches, kept = 0, []
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    end = t_start + ctx.seconds
    while True:
        prev = (ts, w)
        out = rollout(env, ts, w, T)
        consume(out[2], out[3])
        if launches == drawn:
            kept.append(columns(idx, *prev, out))
        ts, w = out[0], out[1]
        launches += 1
        if time.perf_counter() >= end:
            break
    window_s = time.perf_counter() - t_start
    kept.append(columns(idx, *prev, out))
    # the last launch's inputs go back to the allocator, whose blocks the
    # profiled stretch's launches then reuse (no cudaMalloc in it)
    del prev, out
    ctx.log(f"window: {launches} launches in {window_s:.3f} s, set-up {setup_s:.3f} s")

    e2e, trace, brk = {}, {}, None
    if not ctx.trace:
        e2e = {"sim_env_steps_per_s": launches * N * T / window_s, "setup_s": setup_s}
    else:
        n_prof = tf["profile_launches"]
        state = [ts, w]

        def stretch():
            for _ in range(n_prof):
                with torch.profiler.record_function("launch"):
                    ts2, w2, dcnt, chk = rollout(env, state[0], state[1], T)
                with torch.profiler.record_function("consume"):
                    consume(dcnt, chk)
                state[:] = [ts2, w2]

        ok.reset_launches()
        if dev.type == "cuda":
            red = common.profiled(ctx, stretch, ["launch", "consume"], "oc_rollout_kernel",
                                  n_prof)
            trace["profile"] = red
            brk = common.breakdown(red)
        else:
            stretch()
        ctx.log(f"K2 launches in the profiled stretch: {ok.LAUNCHES['fused_rollout']} "
                f"(of {n_prof})")
        trace["k2"] = {"size": env.size, "players": env.num_players, "variant": env.variant,
                       "num_envs": N, "num_steps": T}
    peak = common.memory_peak(dev)
    del ts, w
    common.free(dev)
    checks = judge(ctx, [first] + kept, T)
    return common.Result(e2e=e2e, trace=trace, attempted=launches, failed=0,
                         checks=checks, memory_peak_bytes=peak, breakdown=brk)


def readings(ctx: common.Context, side: str):
    """The compared number of one seed without a window, from the first
    launch: the program's (``side`` "program"), or the frozen env's on the
    sampled worlds with the horizon's auto-reset left out (``"no_reset"``,
    the control: it breaks a guarantee the configuration states)."""
    from madrona_rl_envs_playground_tpu_torch.envs import overcooked as oc_envs
    from madrona_rl_envs_playground_tpu_torch.ops import overcooked as ok

    tf, dev, T = ctx.traffic, ctx.device, ctx.traffic["num_steps"]
    N = tf["num_envs"]
    gen = torch.Generator().manual_seed(ctx.seed)
    idx = torch.randperm(N, generator=gen)[:tf["check_worlds"]].to(dev)
    if side == "program":
        env = oc_envs.make(ctx.config["layout_name"], horizon=ctx.config["horizon"])
        ts = ok.init_packed(env, N, device=dev)
        w = ok.init_action_rng(N, env.num_agents, seed=ctx.seed, device=dev)
        first = columns(idx, ts, w, ok.fused_rollout(env, ts, w, T))
    elif side == "no_reset":
        env = ref_env.make_env(ctx.config)
        w = ref_env.action_words(N, env.num_players, ctx.seed, dev)[:, idx]
        state = ref_env.init_state(env, len(idx), dev)
        rows, tstep = ref_env.pack(state)
        state, w2, dcnt, chk = ref_env.rollout(env, state, w, T, reset=False)
        rows2, tstep2 = ref_env.pack(state)
        first = {"in": (rows, tstep, w), "out": dict(rows=rows2, timestep=tstep2, w=w2,
                                                     dcnt=dcnt, chk=chk)}
    else:
        raise ValueError(f"unknown side {side!r}")
    first["idx"] = idx
    return judge(ctx, [first], T)


def judge(ctx, launches, num_steps):
    """The frozen plain env on the sampled worlds of each kept launch: the
    first from its own fresh state and action words, the others from the
    program's inputs.  Returns the count of values that differ."""
    env = ref_env.make_env(ctx.config)
    k = launches[0]["in"][0].shape[1]
    mismatch = 0
    for i, got in enumerate(launches):
        if i == 0:
            state = ref_env.init_state(env, k, ctx.device)
            w = ref_env.action_words(ctx.traffic["num_envs"], env.num_players, ctx.seed,
                                     ctx.device)[:, got["idx"]]
        else:
            rows, tstep, w = got["in"]
            state = ref_env.unpack(env, rows, tstep)
        state, w, dcnt, chk = ref_env.rollout(env, state, w, num_steps)
        rows, tstep = ref_env.pack(state)
        want = dict(rows=rows, timestep=tstep, w=w, dcnt=dcnt, chk=chk)
        for f in FIELDS:
            mismatch += int((want[f] != got["out"][f]).sum())
    return [common.check("state_mismatch", mismatch, ctx.limits["state_mismatch"])]
