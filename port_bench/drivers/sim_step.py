"""Traffic ``sim_step``: K1 (``ops/overcooked.py`` ``fused_step``) stepped
from the host once a step, as a caller of the simulator's step API does.

Each step draws the actions on the card (uniform over the actions, from a
CUDA ``torch.Generator`` seeded from ``--seed``) and steps every world;
K1 writes the observations, rewards, dones and the next state, and nothing
is read on the host inside the window.  The host waits for the card at the
end of every block of ``block_steps`` steps, which closes the loop.  Set-up
runs ``check_steps`` steps from fresh episodes, which cross the horizon's
reset, keeping the ``check_worlds`` sampled worlds' actions and outputs;
the window keeps the sampled worlds' inputs and outputs at steps drawn
from the seed and at two steps that reset.  The judge holds the set-up's
steps against the frozen plain env from its own fresh state, and each kept
window step from the program's state at its start.
"""

from __future__ import annotations

import time

import torch

from port_bench import common
from port_bench.reference import overcooked as ref_env


def sampled(idx, ts, a, out) -> dict:
    ts2, obs, rew, done = out
    return {"rows": ts.rows[:, idx].clone(), "timestep": ts.timestep[idx].clone(),
            "a": a[:, idx].clone(),
            "out": dict(rows=ts2.rows[:, idx].clone(), timestep=ts2.timestep[idx].clone(),
                        obs=obs[idx].clone(), reward=rew[:, idx].clone(),
                        done=done[idx].clone())}


def run(ctx: common.Context) -> common.Result:
    from madrona_rl_envs_playground_tpu_torch.envs import overcooked as oc_envs
    from madrona_rl_envs_playground_tpu_torch.ops import overcooked as ok

    c, tf, dev = ctx.config, ctx.traffic, ctx.device
    env = oc_envs.make(c["layout_name"], horizon=c["horizon"])
    N, P, A, B = tf["num_envs"], env.num_agents, env.num_actions, tf["block_steps"]
    gen = torch.Generator().manual_seed(ctx.seed)
    idx = torch.randperm(N, generator=gen)[:tf["check_worlds"]].to(dev)
    span = tf["min_window_blocks"] * B
    marks = set(torch.randint(0, span, (tf["window_checks"],), generator=gen).tolist())
    # two window steps at which every world resets (the horizon's last step)
    first_reset = (-tf["check_steps"] - 1) % c["horizon"]
    marks |= {first_reset, first_reset + c["horizon"]}
    act_gen = torch.Generator(device=dev).manual_seed(ctx.seed)

    def step(ts):
        a = torch.randint(0, A, (P, N), generator=act_gen, device=dev, dtype=torch.int32)
        return ok.fused_step(env, ts, a), a

    ts = ok.init_packed(env, N, device=dev)
    start = []
    for _ in range(tf["check_steps"]):
        out, a = step(ts)
        start.append(sampled(idx, ts, a, out))
        ts = out[0]
    common.sync(dev)

    steps, kept = 0, []
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    end = t_start + ctx.seconds
    while True:
        for _ in range(B):
            out, a = step(ts)
            if steps in marks:
                kept.append(sampled(idx, ts, a, out))
            ts = out[0]
            steps += 1
        common.sync(dev)
        if time.perf_counter() >= end:
            break
    window_s = time.perf_counter() - t_start
    ctx.log(f"window: {steps} steps in {window_s:.3f} s, set-up {setup_s:.3f} s")

    e2e, trace, brk = {}, {}, None
    if not ctx.trace:
        e2e = {"sim_env_steps_per_s": steps * N / window_s, "setup_s": setup_s}
    else:
        n_prof = tf["profile_blocks"]
        state = [ts]

        def stretch():
            for _ in range(n_prof):
                with torch.profiler.record_function("block"):
                    for _ in range(B):
                        state[0] = step(state[0])[0][0]
                common.sync(dev)

        ok.reset_launches()
        if dev.type == "cuda":
            red = common.profiled(ctx, stretch, ["block"], "oc_step_kernel", n_prof * B)
            trace["profile"] = red
            brk = common.breakdown(red)
        else:
            stretch()
        ctx.log(f"K1 launches in the profiled stretch: {ok.LAUNCHES['fused_step']} "
                f"(of {n_prof * B})")
        trace["k1"] = {"size": env.size, "players": P, "obs_size": env.obs_size, "num_envs": N}
    peak = common.memory_peak(dev)
    del ts, out, a
    common.free(dev)
    checks = judge(ctx, start, kept)
    return common.Result(e2e=e2e, trace=trace, attempted=steps, failed=0, checks=checks,
                         memory_peak_bytes=peak, breakdown=brk)


def readings(ctx: common.Context, side: str):
    """The compared number of one seed without a window, from the set-up's
    steps: the program's (``side`` "program"), or the frozen env's on the
    sampled worlds with the horizon's auto-reset left out (``"no_reset"``,
    the control: it breaks a guarantee the configuration states), both from
    the same actions."""
    from madrona_rl_envs_playground_tpu_torch.envs import overcooked as oc_envs
    from madrona_rl_envs_playground_tpu_torch.ops import overcooked as ok

    tf, dev = ctx.traffic, ctx.device
    N, A = tf["num_envs"], 6
    gen = torch.Generator().manual_seed(ctx.seed)
    idx = torch.randperm(N, generator=gen)[:tf["check_worlds"]].to(dev)
    act_gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    env = oc_envs.make(ctx.config["layout_name"], horizon=ctx.config["horizon"])
    ref = ref_env.make_env(ctx.config)
    ts = ok.init_packed(env, N, device=dev)
    state = ref_env.init_state(ref, len(idx), dev)
    start = []
    for _ in range(tf["check_steps"]):
        a = torch.randint(0, A, (env.num_agents, N), generator=act_gen, device=dev,
                          dtype=torch.int32)
        if side == "program":
            out = ok.fused_step(env, ts, a)
            start.append(sampled(idx, ts, a, out))
            ts = out[0]
        elif side == "no_reset":
            rows, tstep = ref_env.pack(state)
            state, obs, rew, done = ref_env.step(ref, state, a[:, idx].t(), reset=False)
            rows2, tstep2 = ref_env.pack(state)
            start.append({"rows": rows, "timestep": tstep, "a": a[:, idx],
                          "out": dict(rows=rows2, timestep=tstep2, obs=obs, reward=rew.t(),
                                      done=done)})
        else:
            raise ValueError(f"unknown side {side!r}")
    return judge(ctx, start, [])


def judge(ctx, start, kept):
    """The frozen plain env on the sampled worlds: the set-up's steps from
    its own fresh state, then each kept window step from the program's
    state at its start.  Returns the count of values that differ."""
    env = ref_env.make_env(ctx.config)
    k = start[0]["a"].shape[1]
    mismatch = 0

    def compare(state, got):
        state, obs, rew, done = ref_env.step(env, state, got["a"].t())
        rows, tstep = ref_env.pack(state)
        want = dict(rows=rows, timestep=tstep, obs=obs, reward=rew.t(), done=done)
        return state, sum(int((want[f] != got["out"][f]).sum()) for f in want)

    state = ref_env.init_state(env, k, ctx.device)
    for got in start:
        state, bad = compare(state, got)
        mismatch += bad
    for got in kept:
        _, bad = compare(ref_env.unpack(env, got["rows"], got["timestep"]), got)
        mismatch += bad
    return [common.check("state_mismatch", mismatch, ctx.limits["state_mismatch"])]
