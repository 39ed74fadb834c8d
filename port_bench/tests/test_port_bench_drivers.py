"""Each driver's run at a tiny size on the CPU (the plain versions in the
kernels' place), called directly, never through ``run.py``: it comes out
correct; the controls and the faults planted in the timed path come out not
correct."""

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "port_bench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")

# tiny sizes: every width of the configurations as published, the batches,
# steps and epochs cut
TRAFFIC = {
    "cramped_selfplay_train": dict(num_envs=16, profile_updates=2),
    "simple_mappo_train": dict(num_envs=8, profile_updates=2),
    "cramped_sim_rollout": dict(num_envs=64, num_steps=50, check_worlds=16,
                                min_window_launches=3, profile_launches=2),
    "cramped_sim_step": dict(num_envs=64, block_steps=8, check_steps=45, check_worlds=16,
                             min_window_blocks=3, window_checks=4, profile_blocks=2),
}
CONFIG = {
    "overcooked_cramped_selfplay": dict(horizon=40, recipe=dict(num_steps=8)),
    "overcooked2_simple_mappo": dict(horizon=16, recipe=dict(episode_length=16, ppo_epoch=2)),
}


def small(path: Path) -> dict:
    d = json.loads(path.read_text())
    if path.parent.name == "workloads":
        d["traffic"].update(TRAFFIC[path.stem])
    if path.parent.name == "configs":
        cut = CONFIG[path.stem]
        d["horizon"] = cut["horizon"]
        d["recipe"].update(cut["recipe"])
    return d


def context(workload: str, seed: int = 2**31 + 7, trace: bool = False, seconds: float = 0.3):
    from port_bench import common

    cell = next(w for w in BENCH["workloads"] if w["name"] == workload)
    wl = small(PB / "workloads" / f"{workload}.json")
    config = small(PB / "configs" / f"{cell['config']}.json")
    return common.Context(workload=workload, config=config, traffic=wl["traffic"],
                          limits=wl["limits"], seed=seed, seconds=seconds, trace=trace,
                          device=CPU, t0=time.perf_counter()), wl["driver"]


def driver(name: str):
    import importlib

    return importlib.import_module(f"port_bench.drivers.{name}")


def correct(checks) -> bool:
    return all(c["value"] <= c["limit"] for c in checks)


CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_driver_runs_correct(workload, trace):
    ctx, name = context(workload, trace=trace)
    res = driver(name).run(ctx)
    assert res.attempted > 0 and res.failed == 0
    assert correct(res.checks), res.checks
    if not trace:
        e2e = {m["name"] for m in BENCH["end_to_end"]
               if "workloads" not in m or workload in m["workloads"]}
        assert set(res.e2e) == e2e
    else:
        assert res.e2e == {}
        for key in ("spans", "window", "k1", "k2"):
            for v in res.trace.get(key, {}).values():
                assert v == v  # no NaN


def test_no_jax_in_a_run():
    """The drivers at their tiny sizes in a fresh process load neither JAX
    nor the JAX package (top-level names compared whole)."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import test_port_bench_drivers as t\n"
        "from port_bench import common\n"
        "for w in t.CELLS:\n"
        "    ctx, name = t.context(w, seconds=0.1)\n"
        "    t.driver(name).run(ctx)\n"
        "print(common.loaded_forbidden())\n" % (str(ROOT), str(Path(__file__).parent)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    from port_bench import common

    assert common.loaded_forbidden(["madrona_rl_envs_playground_tpu_torch.train", "jaxtyping",
                                    "flax_like", "numpy"]) == []
    assert common.loaded_forbidden(["jax.numpy", "jaxlib", "flax.linen",
                                    "madrona_rl_envs_playground_tpu.ops"]) == [
        "flax", "jax", "jaxlib", "madrona_rl_envs_playground_tpu"]


# the sides whose readings set the limits, at the tiny sizes; the TF32
# control needs the card (test_tf32_control_on_the_card)
SIDES = [("cramped_selfplay_train", s) for s in ("float8", "half_batch", "action", "frozen")] \
    + [("simple_mappo_train", s) for s in ("half_batch", "action", "frozen")] \
    + [("cramped_sim_rollout", "no_reset"), ("cramped_sim_step", "no_reset")]


@pytest.mark.parametrize("workload,side", SIDES)
def test_control_and_faults_in_the_programs_place_fail(workload, side):
    ctx, name = context(workload)
    assert not correct(driver(name).readings(ctx, side))


@pytest.mark.card
def test_tf32_control_on_the_card(card):
    ctx, name = context("simple_mappo_train")
    ctx.device = card
    wl = json.loads((PB / "workloads" / "simple_mappo_train.json").read_text())
    ctx.traffic["num_envs"] = 800
    checks = driver(name).readings(ctx, "tf32")
    assert not correct(checks), checks
    assert correct(driver(name).readings(ctx, "program")), wl["limits"]


# ---- faults planted in the program, under the whole run -----------------

def _shift_first(fn):
    def shifted(*args, **kwargs):
        a = fn(*args, **kwargs).clone()
        a.view(-1)[0] = (a.view(-1)[0] + 1) % 6
        return a
    return shifted


@contextlib.contextmanager
def planted(workload: str, fault: str, monkeypatch):
    from madrona_rl_envs_playground_tpu_torch.ops import overcooked as ok
    from madrona_rl_envs_playground_tpu_torch.train import optim, selfplay
    from madrona_rl_envs_playground_tpu_torch.train.mappo import policy, trainer

    if fault == "unchanged":
        if workload in ("cramped_sim_rollout", "cramped_sim_step"):
            step = ok.fused_rollout if workload == "cramped_sim_rollout" else ok.fused_step

            def same(env, ts, *args):
                out = step(env, ts, *args)
                return (ts,) + tuple(out[1:])
            monkeypatch.setattr(ok, step.__name__, same)
        else:
            clip = optim.clip_grad_global_norm_

            def zero(params, max_norm):
                params = list(params)
                clip(params, max_norm)
                for p in params:
                    p.grad.zero_()
            monkeypatch.setattr(selfplay, "clip_grad_global_norm_", zero)
            monkeypatch.setattr(trainer, "clip_grad_global_norm_", zero)
    elif fault == "half_batch":
        if workload == "cramped_selfplay_train":
            loss = selfplay.SelfPlayPPO._mb_loss

            def half(self, c):
                return loss(self, {k: v[:, : v.shape[1] // 2] for k, v in c.items()})
            monkeypatch.setattr(selfplay.SelfPlayPPO, "_mb_loss", half)
        else:
            update = trainer.RMAPPOTrainer._ppo_update

            def half(self, sample, sequence=False):
                return update(self, tuple(None if x is None else x[: x.shape[0] // 2]
                                          for x in sample), sequence)
            monkeypatch.setattr(trainer.RMAPPOTrainer, "_ppo_update", half)
    elif fault == "action":
        if workload == "cramped_selfplay_train":
            monkeypatch.setattr(selfplay, "dist_sample", _shift_first(selfplay.dist_sample))
        else:
            monkeypatch.setattr(policy, "dist_sample", _shift_first(policy.dist_sample))
    elif fault == "answer":
        name = "fused_rollout" if workload == "cramped_sim_rollout" else "fused_step"
        fn = getattr(ok, name)

        def altered(*args):
            out = list(fn(*args))
            k = 3 if name == "fused_rollout" else 2  # the checksum, the reward
            out[k] = out[k] + 1
            return tuple(out)
        monkeypatch.setattr(ok, name, altered)
    yield


FAULTS = [(w, f) for w in ("cramped_selfplay_train", "simple_mappo_train")
          for f in ("unchanged", "half_batch", "action", "answer")] \
    + [(w, f) for w in ("cramped_sim_rollout", "cramped_sim_step") for f in ("unchanged", "answer")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_in_the_timed_path_is_not_correct(workload, fault, monkeypatch):
    ctx, name = context(workload, seconds=0.1)
    with planted(workload, fault, monkeypatch):
        res = driver(name).run(ctx)
    assert not correct(res.checks), res.checks
