"""The port's example CLIs (``scripts/torch_*_example.py``) and
``scripts/torch_cartpole_train.py --use-baseline`` on the CPU.

Each example's ``main(argv)`` runs in process with ``--device cpu
--validation --asserts`` at the sizes the JAX package's CLIs are verified
at and must print ``Error rate: 0.0``: every
step of the env (the kernels' plain versions on the CPU) equals the port's
copies of the independent oracles, exactly (Cartpole's float64 oracle
within its own ``atol`` of 1e-6, ``oracles/cartpole.py``).  Also Overcooked's
``--native-validation`` (the batched C++ oracle), ``--use-baseline``,
``--use-async``, ``--use-native`` and ``--isolated``, Hanabi's
``--semantic`` and ``--isolated``, and the card requirement of every new
entry point.
"""

import fcntl
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import torch_balance_example  # noqa: E402
import torch_cartpole_example  # noqa: E402
import torch_cartpole_train  # noqa: E402
import torch_diff_reference_trace  # noqa: E402
import torch_hanabi_example  # noqa: E402
import torch_mappo_train  # noqa: E402
import torch_overcooked2_example  # noqa: E402
import torch_overcooked_example  # noqa: E402
import torch_serve_policy  # noqa: E402
import torch_tester  # noqa: E402

CPU = ["--device", "cpu"]
VALIDATE = ["--validation", "--asserts"]
# the JAX package's verification commands, on the port
EXAMPLES = {
    "cartpole": (torch_cartpole_example.main, ["--num-envs", "32", "--num-steps", "60"]),
    "balance": (torch_balance_example.main, ["--num-envs", "16", "--num-steps", "40"]),
    "overcooked2": (torch_overcooked2_example.main,
                    ["--num-envs", "8", "--num-steps", "40", "--horizon", "30"]),
    "overcooked": (torch_overcooked_example.main,
                   ["--num-envs", "8", "--num-steps", "40", "--horizon", "30"]),
    "hanabi": (torch_hanabi_example.main, ["--num-envs", "8", "--num-steps", "40"]),
}


def native_built():
    """Build the port's native oracle once, under a lock shared with
    ``tests/test_torch_oracles.py``."""
    from madrona_rl_envs_playground_tpu_torch.oracles import native

    lib_dir = Path(native._LIB_PATH).parent
    lib_dir.mkdir(parents=True, exist_ok=True)
    with open(lib_dir / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        native._load()


def run(capsys, main, argv):
    result = main(argv)
    return result, capsys.readouterr().out


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_validates_with_error_rate_zero(name, capsys):
    main, argv = EXAMPLES[name]
    sps, out = run(capsys, main, argv + CPU + VALIDATE)
    lines = out.splitlines()
    assert lines[0].startswith("route: plain (") and "plain version" in lines[0]
    assert lines[-1] == "Error rate: 0.0" and sps > 0


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_overcooked_native_validation(variant, capsys):
    native_built()
    main = torch_overcooked_example.main if variant == "v1" else torch_overcooked2_example.main
    layout = ["--layout", "multiplayer_schelling", "--num-players", "3"] if variant == "v2" else []
    _, out = run(capsys, main, ["--num-envs", "64", "--num-steps", "70", "--horizon", "30",
                                "--native-validation"] + layout + CPU + VALIDATE)
    assert out.splitlines()[-1] == "Error rate: 0.0"


def test_hanabi_semantic_and_three_way(capsys):
    _, out = run(capsys, torch_hanabi_example.main,
                 ["--num-envs", "8", "--num-steps", "60", "--config", "very_small",
                  "--semantic"] + CPU + VALIDATE)
    assert out.splitlines()[-1] == "Error rate: 0.0"


def test_semantic_validator_catches_a_corrupted_step(monkeypatch):
    """``--semantic`` is not idle: one env's obs and state zeroed at one
    step fail it."""
    from madrona_rl_envs_playground_tpu_torch.oracles import hanabi_decoder

    calls = []
    real = hanabi_decoder.validate_step

    def corrupt(env, prev, actions, out, done):
        calls.append(1)
        if len(calls) == 3:
            out.obs[0] = 0
            out.state_obs[0] = 0
        return real(env, prev, actions, out, done)

    monkeypatch.setattr(hanabi_decoder, "validate_step", corrupt)
    with pytest.raises(AssertionError):
        torch_hanabi_example.main(["--num-envs", "4", "--num-steps", "5", "--semantic"] + CPU)
    assert len(calls) == 3


@pytest.mark.parametrize("flag", ["--use-baseline", "--use-async", "--use-native", "--isolated"])
def test_overcooked_backends(flag, capsys):
    if flag == "--use-native":
        native_built()
    sps, out = run(capsys, torch_overcooked_example.main,
                   ["--num-envs", "3", "--num-steps", "6", "--horizon", "30", flag] + CPU)
    assert sps > 0 and "step*worlds/sec" in out


@pytest.mark.parametrize("name", ["cartpole", "balance", "hanabi"])
def test_isolated(name, capsys):
    main, _ = EXAMPLES[name]
    sps, out = run(capsys, main, ["--num-envs", "8", "--num-steps", "10", "--isolated"] + CPU)
    assert sps > 0 and "isolated" in out.splitlines()[-1]


def test_cartpole_train_use_baseline(capsys):
    """One train of the agent over the port's Cartpole oracle envs under
    SyncVectorEnv."""
    curve = torch_cartpole_train.main(["--num-envs", "4", "--num-steps", "16",
                                       "--total-timesteps", "128", "--use-baseline"] + CPU)
    out = capsys.readouterr().out
    assert len(curve) == 1 and out.startswith("update 1/2 return=")
    venv, _, _ = torch_cartpole_train.build(torch_cartpole_train.parse_args(
        ["--num-envs", "2", "--use-baseline"] + CPU))
    assert [e.rs.randint(1 << 30) for e in venv.envs] == [
        np.random.RandomState(s).randint(1 << 30) for s in (1, 2)]


ENTRY_POINTS = {
    "cartpole_example": lambda: torch_cartpole_example.main(["--num-steps", "1"]),
    "balance_example": lambda: torch_balance_example.main(["--num-steps", "1"]),
    "overcooked_example": lambda: torch_overcooked_example.main(["--use-native"]),
    "overcooked2_example": lambda: torch_overcooked2_example.main(["--num-steps", "1"]),
    "hanabi_example": lambda: torch_hanabi_example.main(["--num-steps", "1"]),
    "cartpole_train_baseline": lambda: torch_cartpole_train.main(["--use-baseline"]),
    "diff_reference_trace": lambda: torch_diff_reference_trace.main(
        [str(REPO / "tests" / "data" / "golden" / "balance.npz")]),
    "mappo_train": lambda: torch_mappo_train.main(["--n_rollout_threads", "2"]),
    "tester": lambda: torch_tester.main(["--model_dir", "unused"]),
    "serve_policy": lambda: torch_serve_policy.main(["--checkpoint", "unused"]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_given_the_cpu(name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
