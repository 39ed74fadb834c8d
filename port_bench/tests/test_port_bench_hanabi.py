"""The Hanabi self-play cell (``hanabi_full_selfplay_train``): its driver's
run at a tiny size on the CPU (the plain versions in the kernels' place),
called directly, comes out correct; its controls and the faults planted in
its timed path come out not correct; its two new readers; and on the card
the TF32 control at the cell's batch.

Tiny sizes: 8 worlds x 8 steps, every width of the configuration as
published (658/783 inputs, 3 x 512 towers, 20 moves).
"""

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
CELL = "hanabi_full_selfplay_train"
CPU = torch.device("cpu")


def context(seed: int = 2**31 + 11, trace: bool = False, seconds: float = 0.3,
            num_envs: int = 8, num_steps: int = 8):
    from port_bench import common

    wl = json.loads((PB / "workloads" / f"{CELL}.json").read_text())
    wl["traffic"].update(num_envs=num_envs, profile_updates=2)
    config = json.loads((PB / "configs" / f"{wl['config']}.json").read_text())
    config["recipe"]["num_steps"] = num_steps
    return common.Context(workload=CELL, config=config, traffic=wl["traffic"],
                          limits=wl["limits"], seed=seed, seconds=seconds, trace=trace,
                          device=CPU, t0=time.perf_counter())


def driver():
    from port_bench.drivers import hanabi_selfplay_train

    return hanabi_selfplay_train


def correct(checks) -> bool:
    return all(c["value"] <= c["limit"] for c in checks)


@pytest.mark.parametrize("trace", [False, True])
def test_driver_runs_correct(trace):
    res = driver().run(context(trace=trace))
    assert res.attempted > 0 and res.failed == 0
    assert correct(res.checks), res.checks
    if trace:
        assert res.e2e == {}
        assert res.trace["k3"]["num_envs"] == 8 and res.trace["window"]["flop_per_update"] > 0
    else:
        assert set(res.e2e) == {"train_env_steps_per_s", "setup_s"}


def test_no_jax_in_a_run():
    """The driver at its tiny size in a fresh process loads neither JAX nor
    the JAX package."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import test_port_bench_hanabi as t\n"
        "from port_bench import common\n"
        "t.driver().run(t.context(seconds=0.1))\n"
        "print(common.loaded_forbidden())\n" % (str(ROOT), str(Path(__file__).parent)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("side", ["half_batch", "action", "frozen", "no_credit"])
def test_faults_in_the_programs_place_fail(side):
    assert not correct(driver().readings(context(), side))


@pytest.mark.card
def test_tf32_control_on_the_card(card):
    ctx = context(num_envs=1024, num_steps=64)
    ctx.device = card
    checks = driver().readings(ctx, "tf32")
    assert not correct(checks), checks
    assert correct(driver().readings(ctx, "program")), ctx.limits


# ---- faults planted in the program, under the whole run -----------------

@contextlib.contextmanager
def planted(fault: str, monkeypatch):
    from madrona_rl_envs_playground_tpu_torch.ops import hanabi as hk
    from madrona_rl_envs_playground_tpu_torch.train import optim, selfplay

    if fault == "unchanged":
        clip = optim.clip_grad_global_norm_

        def zero(params, max_norm):
            params = list(params)
            clip(params, max_norm)
            for p in params:
                p.grad.zero_()
        monkeypatch.setattr(selfplay, "clip_grad_global_norm_", zero)
    elif fault == "half_batch":
        loss = selfplay.SelfPlayPPO._mb_loss

        def half(self, c):
            return loss(self, {k: v[:, : v.shape[1] // 2] for k, v in c.items()})
        monkeypatch.setattr(selfplay.SelfPlayPPO, "_mb_loss", half)
    elif fault == "action":
        sample = selfplay.dist_sample

        def shifted(*args, **kwargs):
            a = sample(*args, **kwargs).clone()
            a.view(-1)[0] = (a.view(-1)[0] + 1) % 20
            return a
        monkeypatch.setattr(selfplay, "dist_sample", shifted)
    elif fault == "no_credit":
        monkeypatch.setattr(selfplay, "credit_rewards", lambda r, a, d: (
            r, torch.cat([torch.zeros_like(d[:1]), d[:-1]])))
    elif fault == "answer":
        step = hk.fused_step

        def altered(*args):
            ts, rew, done, counter = step(*args)
            return ts, rew + 1, done, counter
        monkeypatch.setattr(hk, "fused_step", altered)
    yield


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "action", "no_credit", "answer"])
def test_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    with planted(fault, monkeypatch):
        res = driver().run(context(seconds=0.1))
    assert not correct(res.checks), res.checks


# ---- the readers ----------------------------------------------------------

def _reader(name):
    from port_bench.run import reader

    return reader(name)


def test_k3_roofline_reads_the_frozen_bound_over_the_mean_launch():
    from port_bench import yardstick_hanabi

    game = dict(colors=5, ranks=5, players=2, max_information_tokens=8, max_life_tokens=3)
    trace = {"k3": dict(game, num_envs=1024),
             "profile": {"ops": {"hk_step_kernel(Cfg, ...)": {"count": 640, "seconds": 0.0128},
                                 "oc_step_kernel": {"count": 9, "seconds": 1.0}}}}
    want = 100.0 * yardstick_hanabi.k3_bound_ms(game, 1024) / 0.02
    assert abs(_reader("k3_roofline.train").read(trace) - want) < 1e-9
    assert _reader("k3_roofline.train").read({"k3": trace["k3"]}) is None
    assert _reader("k3_roofline.train").read({"profile": trace["profile"]}) is None


def test_inactive_row_share_reads_the_programs_counters():
    value = _reader("inactive_row_share.selfplay").value
    rows = {"count": 5, "sum": 1000.0, "min": 200.0, "max": 200.0}
    snap = {"counters": {"rows:epochs": rows,
                         "active_rows:epochs": {"count": 5, "sum": 480.0, "min": None,
                                                "max": None}}}
    assert abs(value(snap) - 52.0) < 1e-12
    assert value({"counters": {"rows:epochs": rows}}) is None  # an env that never masks
    assert value({"counters": {}}) is None and value(None) is None
