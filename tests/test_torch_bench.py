"""The port's bench line (``scripts/torch_bench.py``) against ``bench.py``.

On the CPU the bench's kernel routes run the plain versions.  At one kernel
block (8 envs) ``bench.py``'s persistent route and the port's rollout route
step the same worlds with the same action streams, so the checksums of two
repeats agree: exactly where they are integer sums (Overcooked, Overcooked2,
Balance Beam; summed as int32 and cast to float32 as ``bench.py`` does), and
within 1e-4 for Cartpole, whose checksum adds float32 positions that the
port's and XLA's sin/cos round differently.  Hanabi's chained rollouts are
held against JAX's in ``tests/test_torch_hanabi.py``, where one interpret
run is cheaper.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
from madrona_rl_envs_playground_tpu_torch.envs import hanabi as t_hanabi  # noqa: E402
from madrona_rl_envs_playground_tpu_torch.envs import overcooked as t_oc  # noqa: E402
from madrona_rl_envs_playground_tpu_torch.ops import overcooked as t_ok  # noqa: E402

_spec = importlib.util.spec_from_file_location("torch_bench", REPO / "scripts" / "torch_bench.py")
tb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tb)

TINY = ["--num-envs", "8", "--num-steps", "4", "--repeats", "1"]


def test_reference_table_is_a_copy_of_bench_py():
    assert tb.REFERENCE_GPU == bench.REFERENCE_GPU
    assert list(tb.REFERENCE_GPU) == list(bench.REFERENCE_GPU)


@pytest.mark.parametrize("args", [[], ["--env", "overcooked2"],
                                  ["--env", "overcooked", "--layout", "simple"],
                                  ["--env", "cartpole"]])
def test_json_line_matches_bench_py(args, monkeypatch, capsys):
    """Both mains at 8 envs x 4 steps x 1 repeat: one JSON line each, the
    same keys in the same order and the same metric name."""
    monkeypatch.setattr(sys, "argv", ["bench.py"] + args + TINY)
    bench.main()
    j_out = capsys.readouterr().out.splitlines()
    tb.main(args + TINY + ["--device", "cpu"])
    t_out = capsys.readouterr().out.splitlines()
    assert len(j_out) == len(t_out) == 1
    j_line, t_line = json.loads(j_out[0]), json.loads(t_out[0])
    assert list(t_line) == list(j_line) == ["metric", "value", "unit", "vs_baseline"]
    assert t_line["metric"] == j_line["metric"] and t_line["unit"] == j_line["unit"]
    assert t_line["value"] > 0


@pytest.mark.parametrize("env,layout", [("overcooked", None), ("overcooked2", None),
                                        ("overcooked", "asymmetric_advantages"),
                                        ("hanabi", None), ("hanabi", "very_small"),
                                        ("cartpole", None), ("balance", None)])
def test_metric_names_match_bench_py(env, layout):
    args = ["--env", env] + (["--layout", layout] if layout else [])
    parsed = tb.parse_args(args)
    tag = parsed.layout or {"overcooked": "cramped_room", "overcooked2": "simple",
                            "hanabi": "full"}.get(env, "")
    assert tb.metric_name(env, layout) == f"{env}{'_' + tag if tag else ''}_steps_per_s"
    assert tb.parse_args([]).num_envs == 524288 and tb.parse_args([]).num_steps == 1000
    assert tb.parse_args([]).repeats == 5 and tb.parse_args([]).backend == "rollout"


@pytest.mark.parametrize("name", ["overcooked", "overcooked2", "cartpole", "balance"])
def test_rollout_checksum_matches_bench_py_persistent(name):
    """One block of 8 envs x 4 steps, two repeats continuing the carry."""
    j_env = bench.make_env(name, None, None)
    j_carry, j_out, j_run = bench.build_rollout(j_env, name, 8, 4, backend="persistent")
    t_env = tb.make_env(name, None, None)
    t_carry, t_run = tb.build_rollout(t_env, name, 8, 4, "rollout", device="cpu")
    for r in range(2):
        j_carry, j_out, j_s = j_run(j_carry, j_out, jax.random.PRNGKey(r))
        t_carry, t_s = t_run(t_carry)
        assert t_s.dtype == torch.float32 and t_s.dim() == 0
        j_s = np.asarray(j_s)
        assert j_s.dtype == np.float32
        if name == "cartpole":
            np.testing.assert_allclose(float(t_s), float(j_s), rtol=0, atol=1e-4)
        else:
            assert float(t_s) == float(j_s), (name, r)


@pytest.mark.parametrize("backend", ["rollout", "step"])
def test_kernel_routes_refuse_what_their_kernels_cannot_take(backend):
    many = t_oc.make("many_player_layout", num_players=None)
    assert not t_ok.fused_supported(many)
    with pytest.raises(SystemExit, match="use --backend env"):
        tb.build_rollout(many, "overcooked", 8, 2, backend, device="cpu")
    three = t_hanabi.Env(colors=2, ranks=5, players=3, max_information_tokens=3,
                         max_life_tokens=2)
    with pytest.raises(SystemExit, match="2-player"):
        tb.build_rollout(three, "hanabi", 8, 2, backend, device="cpu")
    # the env route takes both
    for env, name in ((three, "hanabi"), (t_oc.make("cramped_room"), "overcooked")):
        carry, run = tb.build_rollout(env, name, 4, 2, "env", device="cpu")
        _, s = run(carry)
        assert s.dtype == torch.int32


@pytest.mark.parametrize("name", ["overcooked", "cartpole", "balance", "hanabi"])
@pytest.mark.parametrize("backend", ["step", "env"])
def test_step_and_env_routes_run_and_continue(name, backend):
    env = tb.make_env(name, None, None)
    carry, run = tb.build_rollout(env, name, 8, 3, backend, device="cpu")
    carry, s1 = run(carry)
    carry, s2 = run(carry)
    assert np.isfinite(float(s1)) and np.isfinite(float(s2))


def test_bench_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.bench(TINY)
    line, times = tb.bench(TINY + ["--device", "cpu"])
    assert len(times) == 1 and line["metric"] == "overcooked_cramped_room_steps_per_s"
