"""Traffic ``mappo_train``: the MAPPO runner's loop, ``MAPPORunner.update``
after update, each update's episode score read on the host (as ``update``
does).  The recipe's schedule of updates is cycled; its learning rate is
constant.  No eval and no logger run.

Set-up builds one ``MAPPORunner`` at the configuration's recipe, loads the
weights the benchmark makes from the seed, and drives its first
``check_updates`` updates (the first eager, which captures the collect,
returns and train graphs), keeping what the comparison needs: each
update's step buffers, losses and score, both optimizers' first moments
after the first update, the parameters, the ValueNorm statistics and the
env state after the last.  It runs ``warm_updates`` more, then the window.
With ``--trace 1`` the window records CUDA events around ``_collect``,
``_compute`` and ``trainer.train`` (wrapped on the instances), then a profiled stretch of
``profile_updates`` updates.  Once the window has closed and the runner is
freed, the plain reference (``reference/mappo.py``) follows the checked
updates with the program's actions and judges them.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import math

import torch

from port_bench import common, yardstick
from port_bench.reference import mappo as ref_mappo

NETS = ("actor", "critic")


def phases(runner):
    """The phases of an update that the traced window times: (object,
    method, span name)."""
    return ((runner, "_collect", "collect"), (runner, "_compute", "compute"),
            (runner.trainer, "train", "train"))


def env_and_weights(ctx: common.Context):
    env = ref_mappo.ref_env.make_env(ctx.config)
    return env, ref_mappo.make_weights(ctx.config, env, ctx.seed, ctx.device)


def make_runner(ctx: common.Context, params):
    from madrona_rl_envs_playground_tpu_torch.envs import overcooked2
    from madrona_rl_envs_playground_tpu_torch.train.mappo import MAPPOConfig, MAPPORunner

    c, rc = ctx.config, ctx.config["recipe"]
    fields = {f.name for f in dataclasses.fields(MAPPOConfig)}
    cfg = MAPPOConfig(**{k: v for k, v in rc.items() if k in fields},
                      n_rollout_threads=ctx.traffic["num_envs"], seed=ctx.seed)
    runner = MAPPORunner(cfg, overcooked2.make(c["layout_name"], horizon=c["horizon"]),
                         device=ctx.device)
    runner.policy.actor.load_state_dict(params["actor"])
    runner.policy.critic.load_state_dict(params["critic"])
    return runner


def episodes(ctx: common.Context) -> int:
    """The recipe's number of updates, whose schedule the window cycles."""
    rc = ctx.config["recipe"]
    return int(rc["num_env_steps"]) // (rc["episode_length"] * ctx.traffic["num_envs"])


def checked_updates(ctx, runner, n):
    """``n`` updates through ``update``, keeping what the judge reads."""
    records = []
    collect = runner._collect

    def keep(*args, **kwargs):
        tr = collect(*args, **kwargs)
        records.append({"obs_hash": torch.stack([ref_mappo.obs_hash(o) for o in tr["obs"]]),
                        "action": tr["actions"].clone(), "reward": tr["rewards"].clone(),
                        "done": tr["done"].clone(), "values": tr["values"].clone()})
        return tr

    runner._collect = keep
    pol, first_m, losses, scores = runner.policy, None, [], []
    for u in range(n):
        info, score = runner.update(u, episodes(ctx))
        losses.append(torch.stack([info[k].float().cpu() for k in (
            "value_loss", "policy_loss", "dist_entropy", "ratio")]))
        scores.append(score)
        if u == 0:
            first_m = {net: {name: opt.state[p]["exp_avg"].detach().clone()
                             for name, p in getattr(pol, net).named_parameters()}
                       for net, opt in zip(NETS, (pol.actor_opt, pol.critic_opt))}
    del runner._collect
    params = {net: {k: v.detach().clone() for k, v in getattr(pol, net).named_parameters()}
              for net in NETS}
    vn = runner.trainer.vn
    st = runner.bstate.env_states
    return dict(records=records, losses=losses, scores=scores, first_m=first_m, params=params,
                vn=torch.stack([vn.running_mean, vn.running_mean_sq, vn.debiasing_term]).clone(),
                state={f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)})


def run(ctx: common.Context) -> common.Result:
    tf, rc = ctx.traffic, ctx.config["recipe"]
    env, params = env_and_weights(ctx)
    ctx.log("weights made on the card")
    runner = make_runner(ctx, params)
    ctx.log("runner built")
    kept = checked_updates(ctx, runner, tf["check_updates"])
    ctx.log(f"{tf['check_updates']} checked updates (the first eager, capturing the graphs)")
    n_ep = episodes(ctx)
    count = itertools.count(tf["check_updates"])

    def step():
        _, score = runner.update(next(count) % n_ep, n_ep)
        return math.isfinite(score)

    for _ in range(tf["warm_updates"]):
        step()
    common.sync(ctx.device)
    T, N = rc["episode_length"], tf["num_envs"]
    res = common.train_window(
        ctx, step, phases(runner), world_steps=T * N,
        flop_per_update=yardstick.selfplay_update_flop(
            ref_mappo.widths(ctx.config, env).values(), T * N * env.num_players,
            rc["ppo_epoch"]),
        peak_flop_per_s=yardstick.PEAK_FLOP_PER_S[ctx.config["precision"]["nets"]],
        k1={"size": env.size, "players": env.num_players, "obs_size": env.obs_size,
            "num_envs": N},
        k1_per_update=T)
    del runner
    common.free(ctx.device)
    res.checks = judge(ctx, params, kept)
    return res


# the sides whose readings set the limits (``port_bench/controls.py``): the
# plain reference in the program's place, in TF32 (the control of the
# recipe's float32) or with a fault planted where it is produced
SIDES = {"tf32": (True, None), "half_batch": (False, "half_batch"),
         "action": (False, "action"), "frozen": (False, "frozen")}


def plain_updates(ctx, params, tf32, fault):
    """What ``checked_updates`` keeps, from the plain reference in the
    program's place."""
    side = ref_mappo.PlainMAPPO(ctx.config, ctx.traffic["num_envs"], params, ctx.seed,
                                ctx.device, tf32=tf32, fault=fault)
    records, losses, scores, first_m = [], [], [], None
    for u in range(ctx.traffic["check_updates"]):
        r = side.update()
        records.append({k: r[k] for k in ("obs_hash", "action", "reward", "done", "values")})
        losses.append(r["losses"].cpu())
        scores.append(r["score"])
        if u == 0:
            first_m = {net: {k: v.clone() for k, v in side.m[net].items()} for net in NETS}
    vn = side.vn
    return dict(records=records, losses=losses, scores=scores, first_m=first_m,
                params={net: {k: v.clone() for k, v in side.params[net].items()} for net in NETS},
                vn=torch.stack([vn.mean, vn.mean_sq, vn.debias]),
                state={f.name: getattr(side.state, f.name)
                       for f in dataclasses.fields(side.state)})


def readings(ctx: common.Context, side: str, detail=None):
    """The compared numbers of one seed without a window: the program's
    (``side`` "program") or a side of ``SIDES``; ``detail``, a dict, gets
    each update's losses on both sides."""
    _, params = env_and_weights(ctx)
    if side == "program":
        runner = make_runner(ctx, params)
        kept = checked_updates(ctx, runner, ctx.traffic["check_updates"])
        del runner
        gc.collect()
    else:
        kept = plain_updates(ctx, params, *SIDES[side])
    return judge(ctx, params, kept, detail=detail)


def _flat(tree):
    return {f"{net}.{k}": v for net, d in tree.items() for k, v in d.items()}


def judge(ctx, params, kept, detail=None):
    """The plain reference follows the checked updates with the program's
    actions; returns the compared numbers with their limits."""
    rc, lim = ctx.config["recipe"], ctx.limits
    ref = ref_mappo.PlainMAPPO(ctx.config, ctx.traffic["num_envs"], params, ctx.seed,
                               ctx.device)
    mismatch, gap, value_gap, first_value_gap, loss_gap, first_m = 0, 0.0, 0.0, 0.0, 0.0, None
    coef, vcoef = rc["entropy_coef"], rc["value_loss_coef"]
    for u, rec in enumerate(kept["records"]):
        r = ref.update(rec["action"])
        for k in ("obs_hash", "action", "reward", "done"):
            mismatch += int((r[k] != rec[k].to(r[k].device).reshape(r[k].shape)).sum())
        mismatch += int(r["score"] != kept["scores"][u])
        p, q = [float(x) for x in kept["losses"][u]], [float(x) for x in r["losses"]]
        # every update: the first runs the collect, returns and train eagerly
        # and captures their graphs, the later ones replay them
        gap = max(gap, r["action_gap"])
        vg = common.value_gap(rec["values"], r["values"])
        value_gap = max(value_gap, vg)
        # the loss, value_loss_coef * value + policy - entropy_coef * entropy,
        # over the size of its terms
        loss_gap = max(loss_gap, abs((vcoef * p[0] + p[1] - coef * p[2])
                                     - (vcoef * q[0] + q[1] - coef * q[2]))
                       / max(vcoef * abs(q[0]) + abs(q[1]) + coef * abs(q[2]), 1e-30))
        if u == 0:
            # the first collect alone, from the weights both sides start
            # from: the control's number (later updates drift apart at the
            # recipe's lr of 1e-2 on every seed, as far as TF32 does; PERF.md)
            first_value_gap = vg
            first_m = {net: {k: v.clone() for k, v in ref.m[net].items()} for net in NETS}
        if detail is not None:
            detail.setdefault("losses", []).append([p, q])
            detail.setdefault("action_gaps", []).append(r["action_gap"])
            detail.setdefault("value_gaps", []).append(vg)
    for k, v in kept["state"].items():
        mismatch += int((getattr(ref.state, k) != v.to(torch.int32)).sum())
    ref_vn = torch.stack([ref.vn.mean, ref.vn.mean_sq, ref.vn.debias])
    vn_gap = float(((kept["vn"].to(ref_vn.device) - ref_vn).abs() / ref_vn.abs()).max())
    # leaves the reference's first gradient leaves at rounding (under a
    # thousandth of the median leaf's) move under Adam by round-off alone
    ref_m = _flat(first_m)
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in ref_m.items()}
    median = sorted(norms.values())[len(norms) // 2]
    moving = {k for k, v in norms.items() if v >= 1e-3 * median}
    start, prog, plain = _flat(params), _flat(kept["params"]), _flat(ref.params)
    change_p = {k: prog[k] - start[k] for k in start}
    change_r = {k: plain[k] - start[k] for k in start}
    if detail is not None:
        detail["vn"] = [[float(x) for x in kept["vn"]], [float(x) for x in ref_vn]]
        detail["still"] = sorted(set(norms) - moving)
    return [
        common.check("env_mismatch", mismatch, lim["env_mismatch"]),
        common.check("action_gap", gap, lim["action_gap"]),
        common.check("first_value_gap", first_value_gap, lim["first_value_gap"]),
        common.check("value_gap", value_gap, lim["value_gap"]),
        common.check("loss_gap", loss_gap, lim["loss_gap"]),
        common.check("vn_gap", vn_gap, lim["vn_gap"]),
        common.check("grad_gap", common.leaf_norm_gap(_flat(kept["first_m"]), ref_m),
                     lim["grad_gap"]),
        common.check("change_gap", common.leaf_norm_gap(change_p, change_r, moving),
                     lim["change_gap"]),
    ]
