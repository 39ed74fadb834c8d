"""Traffic ``selfplay_train``: the self-play trainer's loop, update after
update, each update's metrics read on the host as the flagship recipe
logs them (``SelfPlayPPO.run`` with ``log_every`` 1).

Set-up builds one ``SelfPlayPPO`` at the configuration's recipe, loads the
weights the benchmark makes from the seed, and drives its first
``check_updates`` updates through ``train_step`` (the first eager, which
captures the graphs), keeping what the comparison needs: each update's
step buffers and losses, Adam's first moments after the first update, the
parameters and the env state after the last.  It runs ``warm_updates``
more, then the window: ``train_step`` and the metrics read until
``--seconds`` have passed.  With ``--trace 1`` the window records CUDA
events around ``_rollout``, ``_advantage`` and ``_update`` (wrapped on the
instance), then a profiled stretch of ``profile_updates`` updates.  Once
the window has closed and the trainer is freed, the plain reference
(``reference/ppo.py``) follows the checked updates with the program's
actions and judges them.
"""

from __future__ import annotations

import dataclasses
import gc
import math

import torch

from port_bench import common, yardstick
from port_bench.reference import ppo as ref_ppo

PHASES = (("_rollout", "rollout"), ("_advantage", "advantage"), ("_update", "epochs"))


def make_trainer(ctx: common.Context, params):
    from madrona_rl_envs_playground_tpu_torch.envs import overcooked as oc_envs
    from madrona_rl_envs_playground_tpu_torch.train.selfplay import SelfPlayConfig, SelfPlayPPO

    c, rc, tf = ctx.config, ctx.config["recipe"], ctx.traffic
    env = oc_envs.make(c["layout_name"], horizon=c["horizon"])
    cfg = SelfPlayConfig(
        num_steps=rc["num_steps"], gamma=rc["gamma"], gae_lambda=rc["gae_lambda"],
        update_epochs=rc["update_epochs"], num_minibatches=rc["num_minibatches"], lr=rc["lr"],
        ent_coef=rc["ent_coef"], vf_coef=rc["vf_coef"], clip_coef=rc["clip_coef"],
        max_grad_norm=rc["max_grad_norm"], hidden=rc["hidden"], num_layers=rc["num_layers"],
        use_bf16=c["precision"]["towers"] == "bfloat16", value_loss=rc["value_loss"])
    trainer = SelfPlayPPO(env, tf["num_envs"], cfg, seed=ctx.seed, device=ctx.device)
    trainer.net.load_state_dict(params)
    return trainer


def read_metrics(metrics) -> dict:
    """The host read the recipe's logging makes every update."""
    return {k: float(metrics[k]) for k in sorted(metrics)}


def checked_updates(ctx, trainer, n):
    """``n`` updates through ``train_step``, keeping what the judge reads."""
    records = []
    rollout = trainer._rollout

    def keep(*args, **kwargs):
        bstate, out, tr = rollout(*args, **kwargs)
        records.append({"obs_hash": torch.stack([ref_ppo.obs_hash(o) for o in tr["obs"]]),
                        "action": tr["action"].clone(), "values": tr["value"].clone(),
                        "reward": tr["reward"].clone(), "done": tr["done"].clone()})
        return bstate, out, tr

    trainer._rollout = keep
    first_m, losses = None, []
    for u in range(n):
        m = read_metrics(trainer.train_step())
        losses.append(torch.tensor([m["pg_loss"], m["v_loss"], m["entropy"], m["approx_kl"]]))
        if u == 0:
            first_m = {name: trainer.opt.state[p]["exp_avg"].detach().clone()
                       for name, p in trainer.net.named_parameters()}
    del trainer._rollout
    params = {k: v.detach().clone() for k, v in trainer.net.named_parameters()}
    st = trainer.state["bstate"].env_states
    state = {f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)}
    return dict(records=records, losses=losses, first_m=first_m, params=params, state=state)


def weights(ctx: common.Context):
    """The towers' widths and the weights made from the seed."""
    widths = ref_ppo.towers(ctx.config, ref_ppo.ref_env.make_env(ctx.config))
    return widths, ref_ppo.make_weights(widths, ctx.seed, ctx.device)


def run(ctx: common.Context) -> common.Result:
    tf, rc = ctx.traffic, ctx.config["recipe"]
    widths, params = weights(ctx)
    ctx.log("weights made on the card")
    trainer = make_trainer(ctx, params)
    env = trainer.env
    rows = tf["num_envs"] * env.num_agents * rc["num_steps"]
    ctx.log("trainer built")
    kept = checked_updates(ctx, trainer, tf["check_updates"])
    ctx.log(f"{tf['check_updates']} checked updates (the first eager, capturing the graphs)")

    def step():
        return all(math.isfinite(v) for v in read_metrics(trainer.train_step()).values())

    for _ in range(tf["warm_updates"]):
        step()
    common.sync(ctx.device)
    res = common.train_window(
        ctx, step, [(trainer, attr, name) for attr, name in PHASES],
        world_steps=tf["num_envs"] * rc["num_steps"],
        flop_per_update=yardstick.selfplay_update_flop(widths.values(), rows,
                                                       rc["update_epochs"]),
        peak_flop_per_s=yardstick.PEAK_FLOP_PER_S[ctx.config["precision"]["towers"]],
        k1={"size": env.size, "players": env.num_players, "obs_size": env.obs_size,
            "num_envs": tf["num_envs"]},
        k1_per_update=rc["num_steps"])
    del trainer
    common.free(ctx.device)
    res.checks = judge(ctx, params, kept)
    return res


# the sides whose readings set the limits (``port_bench/controls.py``):
# the plain reference put in the program's place, in float8 (the control of
# the recipe's bfloat16 towers) or with a fault planted where it is produced
SIDES = {"float8": ("float8", None), "half_batch": (None, "half_batch"),
         "action": (None, "action"), "frozen": (None, "frozen")}


def plain_updates(ctx, params, precision, fault):
    """What ``checked_updates`` keeps, from the plain reference in the
    program's place."""
    n = ctx.traffic["check_updates"]
    side = ref_ppo.PlainSelfPlay(ctx.config, ctx.traffic["num_envs"], params, ctx.seed,
                                 ctx.device, precision=precision, fault=fault)
    records, losses, first_m = [], [], None
    for u in range(n):
        r = side.update()
        records.append({k: r[k] for k in ("obs_hash", "action", "reward", "done", "values")})
        losses.append(r["losses"].cpu())
        if u == 0:
            first_m = {k: v.clone() for k, v in side.m.items()}
    state = {f.name: getattr(side.state, f.name) for f in dataclasses.fields(side.state)}
    return dict(records=records, losses=losses, first_m=first_m,
                params={k: v.clone() for k, v in side.params.items()}, state=state)


def readings(ctx: common.Context, side: str, detail=None):
    """The compared numbers of one seed without a window: the program's
    (``side`` "program") or a side of ``SIDES``; ``detail``, a dict, gets
    each update's losses on both sides."""
    _, params = weights(ctx)
    if side == "program":
        trainer = make_trainer(ctx, params)
        kept = checked_updates(ctx, trainer, ctx.traffic["check_updates"])
        del trainer
        gc.collect()
    else:
        kept = plain_updates(ctx, params, *SIDES[side])
    return judge(ctx, params, kept, detail=detail)


def judge(ctx, params, kept, detail=None):
    """The plain reference follows the checked updates with the program's
    actions; returns the compared numbers with their limits.  ``detail``, a
    dict, gets each update's losses on both sides and the reference's
    gradient norms before the clip."""
    rc, lim = ctx.config["recipe"], ctx.limits
    ref = ref_ppo.PlainSelfPlay(ctx.config, ctx.traffic["num_envs"], params, ctx.seed,
                                ctx.device)
    mismatch, gap, value_gap = 0, 0.0, 0.0
    loss_gap = {True: 0.0, False: 0.0}  # with and without the value loss
    first_m = None
    for u, rec in enumerate(kept["records"]):
        r = ref.update(rec["action"])
        for k in ("obs_hash", "action", "reward", "done"):
            mismatch += int((r[k] != rec[k].to(r[k].device).reshape(r[k].shape)).sum())
        gap = max(gap, r["action_gap"])
        # the critic's forward over the rollout
        vg = common.value_gap(rec["values"], r["values"])
        value_gap = max(value_gap, vg)
        prog_l = kept["losses"][u]
        for value in loss_gap:
            (ref_loss, scale), (prog_loss, _) = (ref_ppo.loss(rc, x, value)
                                                 for x in (r["losses"], prog_l))
            loss_gap[value] = max(loss_gap[value],
                                  abs(prog_loss - ref_loss) / max(scale, 1e-30))
        if u == 0:
            first_m = {k: v.clone() for k, v in ref.m.items()}
        if detail is not None:
            detail.setdefault("losses", []).append(
                [[float(x) for x in prog_l], [float(x) for x in r["losses"]]])
            detail.setdefault("action_gaps", []).append(r["action_gap"])
            detail.setdefault("value_gaps", []).append(vg)
    if detail is not None:
        detail["grad_norms"] = ref.grad_norms
    for k, v in kept["state"].items():
        mismatch += int((getattr(ref.state, k) != v.to(torch.int32)).sum())
    # leaves the reference's first gradient leaves at rounding (under a
    # thousandth of the median leaf's) move under Adam by round-off alone
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in first_m.items()}
    median = sorted(norms.values())[len(norms) // 2]
    moving = {k for k, v in norms.items() if v >= 1e-3 * median}
    change_p = {k: kept["params"][k] - params[k] for k in params}
    change_r = {k: ref.params[k] - params[k] for k in params}
    return [
        common.check("env_mismatch", mismatch, lim["env_mismatch"]),
        common.check("action_gap", gap, lim["action_gap"]),
        common.check("value_gap", value_gap, lim["value_gap"]),
        common.check("loss_gap", loss_gap[True], lim["loss_gap"]),
        # the policy part alone, pg - ent_coef * entropy: the float8
        # control's number; the whole loss's value term steps with the
        # bfloat16 critic's roundings (PERF.md)
        common.check("pg_loss_gap", loss_gap[False], lim["pg_loss_gap"]),
        common.check("grad_gap", common.leaf_norm_gap(kept["first_m"], first_m),
                     lim["grad_gap"]),
        common.check("change_gap", common.leaf_norm_gap(change_p, change_r, moving),
                     lim["change_gap"]),
    ]
