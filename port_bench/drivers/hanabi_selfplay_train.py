"""Traffic ``hanabi_selfplay_train``: the self-play trainer's loop on a
turn-based game, update after update, each update's metrics read on the
host as ``SelfPlayPPO.run`` with ``log_every`` 1 does.

Set-up builds one ``SelfPlayPPO`` over the configuration's Hanabi game
(K3, ``hk_step_kernel``, through ``train/fused_collect.py``'s Hanabi
collector on the card), loads the weights the benchmark makes from the
seed, and drives its first ``check_updates`` updates through
``train_step`` (the first eager, which captures the rollout, scan and
epochs graphs), keeping what the comparison needs: each update's step
buffers (the obs and state-obs hashes, the masks, the active flags, the
actions, values, rewards and dones) and losses, Adam's first moments after
the first update, the parameters and the env state after the last.  It
runs ``warm_updates`` more, then the window: ``train_step`` and the
metrics read until ``--seconds`` have passed.  With ``--trace 1`` the
window records CUDA events around ``_rollout``, ``_advantage`` and
``_update`` (wrapped on the instance), then a profiled stretch of
``profile_updates`` updates, K3's records counted; the trace carries K3's
shape under ``k3``.  Once the window has closed and the trainer is freed,
the plain reference (``reference/hanabi_ppo.py`` over
``reference/hanabi.py``) follows the checked updates with the program's
actions and judges them.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import torch

from port_bench import common, yardstick
from port_bench.reference import hanabi as ref_env
from port_bench.reference import hanabi_ppo as ref_hppo
from port_bench.reference import ppo as ref_ppo

PHASES = (("_rollout", "rollout"), ("_advantage", "advantage"), ("_update", "epochs"))
K3 = "hk_step_kernel"
# the step buffers the judge compares exactly
EXACT = ("obs_hash", "state_hash", "mask", "active", "reward", "done")


def make_trainer(ctx: common.Context, params):
    from madrona_rl_envs_playground_tpu_torch.envs import hanabi
    from madrona_rl_envs_playground_tpu_torch.train.selfplay import SelfPlayConfig, SelfPlayPPO

    c, rc, tf = ctx.config, ctx.config["recipe"], ctx.traffic
    if c["precision"]["towers"] != "float32":
        raise ValueError("the cell's towers are float32")
    env = hanabi.Env(**c["game"])
    cfg = SelfPlayConfig(
        num_steps=rc["num_steps"], gamma=rc["gamma"], gae_lambda=rc["gae_lambda"],
        update_epochs=rc["update_epochs"], num_minibatches=rc["num_minibatches"], lr=rc["lr"],
        ent_coef=rc["ent_coef"], vf_coef=rc["vf_coef"], clip_coef=rc["clip_coef"],
        max_grad_norm=rc["max_grad_norm"], hidden=rc["hidden"], num_layers=rc["num_layers"],
        use_bf16=False, value_loss=rc["value_loss"])
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
        records.append({
            "obs_hash": torch.stack([ref_ppo.obs_hash(o) for o in tr["obs"]]),
            "state_hash": torch.stack([ref_ppo.obs_hash(o) for o in tr["state_obs"]]),
            "mask": tr["mask"].clone(), "active": tr["active"].clone(),
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
    bstate = trainer.state["bstate"]
    st = bstate.env_states
    state = {f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st)}
    state["episode_counter"] = bstate.episode_counter.clone()
    return dict(records=records, losses=losses, first_m=first_m, params=params, state=state)


def weights(ctx: common.Context):
    """The towers' widths and the weights made from the seed."""
    widths = ref_ppo.towers(ctx.config, ref_env.make_env(ctx.config))
    return widths, ref_ppo.make_weights(widths, ctx.seed, ctx.device)


def k3_shape(ctx: common.Context) -> dict:
    return dict(ctx.config["game"], num_envs=ctx.traffic["num_envs"])


def train_window(ctx, trainer, step, world_steps: int, flop_per_update: float,
                 peak_flop_per_s: float) -> common.Result:
    """The measured window, and with ``--trace 1`` its spans and profiled
    stretch (``common.train_window``'s, with K3 in K1's place): ``step()``
    runs one update through the cell's own call and the host read, and
    returns whether what it read was finite; an update steps
    ``world_steps`` worlds and launches K3 once a step."""
    spans = common.Spans(ctx.device)
    if ctx.trace:
        for attr, name in PHASES:
            spans.wrap(trainer, attr, name)
    failed = updates = 0
    stamps = [time.perf_counter()]
    setup_s = stamps[0] - ctx.t0
    end = stamps[0] + ctx.seconds
    while True:
        failed += not step()
        updates += 1
        stamps.append(time.perf_counter())
        if stamps[-1] >= end:
            break
    window_s = stamps[-1] - stamps[0]
    each = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    ctx.log(f"window: {updates} updates in {window_s:.3f} s, set-up {setup_s:.3f} s; ms an "
            f"update min {each[0] * 1e3:.2f}, median {each[len(each) // 2] * 1e3:.2f}, "
            f"max {each[-1] * 1e3:.2f}")

    res = common.Result(e2e={}, trace={}, attempted=updates, failed=failed, checks=[],
                        memory_peak_bytes=0)
    if not ctx.trace:
        res.e2e = {"train_env_steps_per_s": updates * world_steps / window_s,
                   "setup_s": setup_s}
    else:
        from madrona_rl_envs_playground_tpu_torch.ops import hanabi as hk

        res.trace["spans"] = {name: spans.total_ms(name) / updates for _, name in PHASES}
        res.trace["window"] = {"seconds": window_s, "updates": updates,
                               "flop_per_update": flop_per_update,
                               "peak_flop_per_s": peak_flop_per_s}
        hk.reset_launches()
        n_prof = ctx.traffic["profile_updates"]
        per_update = ctx.config["recipe"]["num_steps"]

        def stretch():
            for _ in range(n_prof):
                with torch.profiler.record_function("update"):
                    step()

        if ctx.device.type == "cuda":
            red = common.profiled(ctx, stretch, [n for _, n in PHASES] + ["update"], K3,
                                  n_prof * per_update)
            res.trace["profile"] = red
            res.breakdown = common.breakdown(red)
        else:
            stretch()
        launches = hk.LAUNCHES["fused_step"]
        ctx.log(f"K3 launches in the profiled stretch: {launches} "
                f"({launches / n_prof:.1f} an update, {per_update} steps an update)")
        res.trace["launches_per_update"] = launches / n_prof
        res.trace["k3"] = k3_shape(ctx)
        for attr, _ in PHASES:
            common.Spans.unwrap(trainer, attr)
    res.memory_peak_bytes = common.memory_peak(ctx.device)
    return res


def run(ctx: common.Context) -> common.Result:
    tf, rc = ctx.traffic, ctx.config["recipe"]
    widths, params = weights(ctx)
    ctx.log("weights made on the card")
    trainer = make_trainer(ctx, params)
    rows = tf["num_envs"] * trainer.env.num_agents * rc["num_steps"]
    ctx.log("trainer built")
    kept = checked_updates(ctx, trainer, tf["check_updates"])
    ctx.log(f"{tf['check_updates']} checked updates (the first eager, capturing the graphs)")

    def step():
        return all(math.isfinite(v) for v in read_metrics(trainer.train_step()).values())

    for _ in range(tf["warm_updates"]):
        step()
    common.sync(ctx.device)
    res = train_window(
        ctx, trainer, step, world_steps=tf["num_envs"] * rc["num_steps"],
        flop_per_update=yardstick.selfplay_update_flop(widths.values(), rows,
                                                       rc["update_epochs"]),
        peak_flop_per_s=yardstick.PEAK_FLOP_PER_S[ctx.config["precision"]["towers"]])
    del trainer
    common.free(ctx.device)
    res.checks = judge(ctx, params, kept)
    return res


# the sides whose readings set the limits (``port_bench/controls.py``):
# the plain reference put in the program's place, in TF32 (the control of
# the recipe's float32 towers) or with a fault planted where it is produced
SIDES = {"tf32": ("tf32", None), "half_batch": (None, "half_batch"),
         "action": (None, "action"), "frozen": (None, "frozen"),
         "no_credit": (None, "no_credit")}


def plain_updates(ctx, params, precision, fault):
    """What ``checked_updates`` keeps, from the plain reference in the
    program's place."""
    side = ref_hppo.PlainHanabiSelfPlay(ctx.config, ctx.traffic["num_envs"], params, ctx.seed,
                                        ctx.device, precision=precision, fault=fault)
    records, losses, first_m = [], [], None
    for u in range(ctx.traffic["check_updates"]):
        r = side.update()
        records.append({k: r[k] for k in EXACT + ("action", "values")})
        losses.append(r["losses"].cpu())
        if u == 0:
            first_m = {k: v.clone() for k, v in side.m.items()}
    state = {f: getattr(side.state, f) for f in ref_env.FIELDS}
    state["episode_counter"] = side.counter
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
    dict, gets each update's losses on both sides, the gaps by update and
    the reference's gradient norms before the clip."""
    rc, lim = ctx.config["recipe"], ctx.limits
    ref = ref_hppo.PlainHanabiSelfPlay(ctx.config, ctx.traffic["num_envs"], params, ctx.seed,
                                       ctx.device)
    mismatch, gap, value_gaps = 0, 0.0, []
    loss_gap = {True: 0.0, False: 0.0}  # with and without the value loss
    first_m = None
    for u, rec in enumerate(kept["records"]):
        r = ref.update(rec["action"])
        for k in EXACT:
            mismatch += int((r[k] != rec[k].to(r[k].device).reshape(r[k].shape)).sum())
        gap = max(gap, r["action_gap"])
        vg = common.value_gap(rec["values"], r["values"])
        value_gaps.append(vg)
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
            detail.setdefault("trainable", []).append(int(r["trainable"].sum()))
    if detail is not None:
        detail["grad_norms"] = ref.grad_norms
    ref_state = {f: getattr(ref.state, f) for f in ref_env.FIELDS}
    ref_state["episode_counter"] = ref.counter
    for k, v in ref_state.items():
        mismatch += int((kept["state"][k].to(v.device).to(v.dtype) != v).sum())
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
        # the first rollout's values, from the weights both sides start with:
        # equal where both compute the towers in float32 (PERF.md)
        common.check("first_value_gap", value_gaps[0], lim["first_value_gap"]),
        common.check("value_gap", max(value_gaps), lim["value_gap"]),
        common.check("loss_gap", loss_gap[True], lim["loss_gap"]),
        common.check("pg_loss_gap", loss_gap[False], lim["pg_loss_gap"]),
        common.check("grad_gap", common.leaf_norm_gap(kept["first_m"], first_m),
                     lim["grad_gap"]),
        common.check("change_gap", common.leaf_norm_gap(change_p, change_r, moving),
                     lim["change_gap"]),
    ]
