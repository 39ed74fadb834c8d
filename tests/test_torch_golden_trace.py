"""The port's golden traces (``utils/golden_trace.py``,
``scripts/torch_diff_reference_trace.py``) against the JAX package's.

The JAX tests of ``tests/test_golden_trace.py`` on the port (a self-match,
corrupted obs, reward and done caught, a perturbed action stream diverging,
the Hanabi round trip, the CLI's exit codes), then across the packages:

* the committed traces in ``tests/data/golden/`` are JAX's ``record_trace``
  at 16 envs x 120 steps, seed 0 (``test_committed_traces_are_jax_recordings``
  re-records each with JAX and compares its arrays and meta);
* each replays through the port's ``diff_trace`` on the CPU (the kernels'
  plain versions), Hanabi's uniform draws over every move, legal or not,
  included;
* a trace the port records replays through JAX's ``diff_trace``.

Tolerance: exact, as ``diff_trace`` compares, except Cartpole's float obs:
XLA and PyTorch round a reset's draw differently by up to ~1e-8, which the
dynamics carry on, so there ``dones`` and ``rewards`` are exact and ``obs``
within ``tests/test_torch_cartpole.py``'s ``FREE_TOL`` (atol 1e-4), the
card's criterion too (``chip_smoke.py``'s ``phase_golden_traces``).

To write the committed traces again (on the CPU, with JAX):

    JAX_PLATFORMS=cpu python -m tests.test_torch_golden_trace
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from madrona_rl_envs_playground_tpu.core.batch import Simulator as JSimulator
from madrona_rl_envs_playground_tpu.utils import golden_trace as jgt
from madrona_rl_envs_playground_tpu_torch.envs import hanabi, overcooked2
from madrona_rl_envs_playground_tpu_torch.utils import golden_trace as tgt

REPO = Path(__file__).resolve().parents[1]
GOLDEN_DIR = REPO / "tests" / "data" / "golden"
SOURCE = "madrona_rl_envs_playground_tpu record_trace (JAX, CPU)"
NUM_ENVS, NUM_STEPS, SEED = 16, 120, 0
# file name -> the env, layout and horizon of its meta (JAX's make_env_from_meta:
# "overcooked" is the v1 env, "overcooked2" the v2 env)
GOLDEN = {
    "overcooked_v1_cramped_room": dict(env="overcooked", layout="cramped_room", horizon=100),
    "overcooked_v2_cramped_room": dict(env="overcooked2", layout="cramped_room", horizon=100),
    "hanabi_full": dict(env="hanabi", layout="full", horizon=None),
    "balance": dict(env="balance", layout=None, horizon=None),
    "cartpole": dict(env="cartpole", layout=None, horizon=None),
}
FREE_TOL = dict(rtol=0, atol=1e-4)
CPU = "cpu"

META = {"env": "overcooked2", "layout": "cramped_room", "num_envs": 4,
        "num_steps": 12, "horizon": 8, "source": "synthetic"}


def golden_meta(name):
    return dict(GOLDEN[name], num_envs=NUM_ENVS, num_steps=NUM_STEPS, seed=SEED, source=SOURCE)


def record_golden(name):
    """(meta, arrays) of a golden trace, recorded by JAX."""
    meta = golden_meta(name)
    return meta, jgt.record_trace(jgt.make_env_from_meta(meta), NUM_ENVS, NUM_STEPS, seed=SEED)


def golden_path(name) -> Path:
    return GOLDEN_DIR / f"{name}.npz"


def _fixture(tmp_path, mutate=None):
    env = overcooked2.make("cramped_room", horizon=8)
    arrays = tgt.record_trace(env, 4, 12, seed=0, device=CPU)
    if mutate is not None:
        mutate(arrays)
    path = str(tmp_path / "trace.npz")
    tgt.save_trace(path, META, **arrays)
    return path


def test_selfmatch_bitwise(tmp_path):
    summary = tgt.diff_trace(tgt.load_trace(_fixture(tmp_path)), device=CPU)
    assert summary["ok"], summary
    assert summary["route"] == "plain"  # the kernel's plain version on the CPU
    assert summary["fields"]["obs"]["mismatch"] == 0
    assert summary["fields"]["obs"]["total"] > 0


def test_corrupted_obs_caught(tmp_path):
    def mutate(a):
        a["obs"][5, 2, 1, 17] ^= 1

    summary = tgt.diff_trace(tgt.load_trace(_fixture(tmp_path, mutate)), device=CPU)
    assert not summary["ok"]
    f = summary["fields"]["obs"]
    assert f["mismatch"] == 1
    assert f["first"][0]["step"] == 5
    assert f["first"][0]["index"] == [2, 1, 17]


def test_corrupted_reward_and_done_caught(tmp_path):
    def mutate(a):
        a["rewards"][3, 1, 0] += 1.0
        a["dones"][7, 2] = ~a["dones"][7, 2]

    summary = tgt.diff_trace(tgt.load_trace(_fixture(tmp_path, mutate)), device=CPU)
    assert not summary["ok"]
    assert summary["fields"]["rewards"]["mismatch"] == 1
    assert summary["fields"]["dones"]["mismatch"] == 1


def test_perturbed_action_stream_diverges(tmp_path):
    """Changing one action cascades into obs mismatches: the differ replays
    the port with the recorded actions."""

    def mutate(a):
        a["actions"][2, 0, 0] = (a["actions"][2, 0, 0] + 1) % 6

    summary = tgt.diff_trace(tgt.load_trace(_fixture(tmp_path, mutate)), device=CPU)
    assert not summary["ok"]
    assert summary["fields"]["obs"]["mismatch"] > 0


def test_hanabi_trace_roundtrip(tmp_path):
    """The masked turn-based env through the same harness, mask and active
    fields included."""
    env = hanabi.Env(**hanabi.CONFIGS["very_small"])
    arrays = tgt.record_trace(env, 4, 10, seed=1, device=CPU)
    meta = {"env": "hanabi", "layout": "very_small", "num_envs": 4,
            "num_steps": 10, "source": "synthetic"}
    path = str(tmp_path / "h.npz")
    tgt.save_trace(path, meta, **arrays)
    summary = tgt.diff_trace(tgt.load_trace(path), device=CPU)
    assert summary["ok"], summary
    assert summary["fields"]["action_mask"]["total"] > 0
    assert summary["fields"]["active"]["total"] > 0


def _cli(*args):
    return subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_diff_reference_trace.py"), *args],
        capture_output=True, text=True, timeout=300)


def test_cli_exit_codes(tmp_path):
    """scripts/torch_diff_reference_trace.py: 0 on a match, 1 on a mismatch,
    and without a card it refuses unless given --device cpu."""
    good = _fixture(tmp_path)
    r = _cli(good, "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "MATCH" in r.stdout and '"route": "plain"' in r.stdout

    bad = str(tmp_path / "bad.npz")
    arrays = tgt.record_trace(overcooked2.make("cramped_room", horizon=8), 4, 12, seed=0,
                              device=CPU)
    arrays["obs0"] = arrays["obs0"].copy()
    arrays["obs0"][0, 0, 0] ^= 1
    tgt.save_trace(bad, META, **arrays)
    r = _cli(bad, "--device", "cpu")
    assert r.returncode == 1
    assert "MISMATCH" in r.stdout

    r = _cli(good)
    assert r.returncode != 0 and "no CUDA device" in r.stderr and "MATCH" not in r.stdout


def assert_replays(summary, name, replayed=None, want=None):
    """``summary`` of a cross-package replay is ok; for Cartpole, dones and
    rewards exact and obs within FREE_TOL (``replayed`` and ``want``: the
    replay's and the trace's obs, reset first)."""
    if name != "cartpole":
        assert summary["ok"], summary
        return
    for k in ("rewards", "dones", "action_mask", "active"):
        assert summary["fields"][k]["mismatch"] == 0, summary
    np.testing.assert_allclose(replayed, want, **FREE_TOL)


def _port_obs(trace):
    _, steps = tgt.replay(trace, device=CPU)
    return np.stack([out.obs.numpy() for _, out in steps])


@pytest.mark.parametrize("name", list(GOLDEN))
def test_jax_recorded_trace_replays_on_the_port(name):
    """Each committed JAX recording replays through the port's diff_trace on
    the CPU (Hanabi: every seat's action uniform over all moves)."""
    trace = tgt.load_trace(str(golden_path(name)))
    summary = tgt.diff_trace(trace, device=CPU)
    assert summary["route"] == "plain"
    assert summary["num_envs"] == NUM_ENVS and summary["steps"] == NUM_STEPS
    want = np.concatenate([trace.obs0[None], trace.obs])
    assert_replays(summary, name, _port_obs(trace) if name == "cartpole" else None, want)
    if name == "hanabi_full":  # the recording plays illegal moves too
        seat = trace.active[:-1].argmax(-1)  # the seat to act at steps 1 .. T-1
        moves = np.take_along_axis(trace.actions[1:], seat[..., None], -1)[..., 0]
        legal = trace.action_mask[:-1][np.arange(NUM_STEPS - 1)[:, None],
                                       np.arange(NUM_ENVS), seat, moves]
        assert legal.any() and not legal.all()


@pytest.mark.parametrize("name", list(GOLDEN))
def test_port_recorded_trace_replays_in_jax(name, tmp_path):
    meta = golden_meta(name)
    arrays = tgt.record_trace(tgt.make_env_from_meta(meta), NUM_ENVS, 40, seed=3, device=CPU)
    path = str(tmp_path / "port.npz")
    tgt.save_trace(path, dict(meta, num_steps=40, source="port"), **arrays)
    trace = jgt.load_trace(path)
    summary = jgt.diff_trace(trace)
    if name == "cartpole":
        sim = JSimulator(jgt.make_env_from_meta(meta), NUM_ENVS)
        got = [np.asarray(sim.last_out.obs)]
        got += [np.asarray(sim.step(jnp.asarray(a)).obs) for a in trace.actions]
        assert_replays(summary, name, np.stack(got),
                       np.concatenate([trace.obs0[None], trace.obs]))
    else:
        assert_replays(summary, name)


@pytest.mark.parametrize("name", list(GOLDEN))
def test_committed_traces_are_jax_recordings(name):
    """The recipe lives here: JAX's record_trace re-records each committed
    trace with the same arrays and meta (the compressed bytes are not
    compared)."""
    meta, arrays = record_golden(name)
    trace = jgt.load_trace(str(golden_path(name)))
    assert trace.meta == meta
    for k, v in arrays.items():
        got = getattr(trace, k)
        assert got.dtype == v.dtype and got.shape == v.shape, k
        np.testing.assert_array_equal(got, v, err_msg=k)


def write_golden() -> None:
    GOLDEN_DIR.mkdir(parents=True, exist_ok=True)
    for name in GOLDEN:
        meta, arrays = record_golden(name)
        jgt.save_trace(str(golden_path(name)), meta, **arrays)
        print(f"{golden_path(name).relative_to(REPO)}: {golden_path(name).stat().st_size} B")


if __name__ == "__main__":
    write_golden()
