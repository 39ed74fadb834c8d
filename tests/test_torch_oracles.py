"""The port's oracles (``madrona_rl_envs_playground_tpu_torch/oracles/``)
against the JAX package's.

Each is that package's file line for line with its own module docstring,
which the AST comparison drops; ``native.py`` also differs in where it
builds its library (``build/native/``, never ``native/``), which the
comparison undoes before it compares.  Driven on the same inputs, the two
packages' oracles give the same streams, exactly: the Hanabi
``RecordingOracle`` and ``RulesHanabi(cxx_quirks=True)`` pair, the
``OvercookedOracle`` on cramped_room, and the batched C++ oracle at 64 envs
x 100 steps.
"""

import ast
import fcntl
import os
from pathlib import Path

import numpy as np
import pytest

import madrona_rl_envs_playground_tpu.oracles as joracles
import madrona_rl_envs_playground_tpu_torch.oracles as toracles

REPO = Path(__file__).resolve().parents[1]
JAX_DIR = REPO / "madrona_rl_envs_playground_tpu" / "oracles"
PORT_DIR = REPO / "madrona_rl_envs_playground_tpu_torch" / "oracles"
COPIED = ("cartpole", "balance_beam", "hanabi", "hanabi_rules", "hanabi_decoder",
          "overcooked", "adapters", "native")


def _body(path: Path) -> ast.Module:
    """The module without its docstring."""
    mod = ast.parse(path.read_text())
    assert isinstance(mod.body[0], ast.Expr) and isinstance(mod.body[0].value, ast.Constant)
    mod.body = mod.body[1:]
    return mod


def _undo_build_dir(mod: ast.Module) -> ast.Module:
    """The port's native.py with JAX's build path: drop ``_BUILD_DIR`` and
    ``_build``'s ``os.makedirs``, and read ``_LIB_PATH`` from ``_NATIVE_DIR``."""
    body = []
    for node in mod.body:
        targets = [t.id for t in getattr(node, "targets", []) if isinstance(t, ast.Name)]
        if targets == ["_BUILD_DIR"]:
            continue
        if targets == ["_LIB_PATH"]:
            for n in ast.walk(node):
                if isinstance(n, ast.Name) and n.id == "_BUILD_DIR":
                    n.id = "_NATIVE_DIR"
        if isinstance(node, ast.FunctionDef) and node.name == "_build":
            node.body = [s for s in node.body if "makedirs" not in ast.unparse(s)]
        body.append(node)
    mod.body = body
    return mod


@pytest.mark.parametrize("name", COPIED)
def test_oracle_code_equals_jax(name):
    port = _body(PORT_DIR / f"{name}.py")
    if name == "native":
        src = (PORT_DIR / "native.py").read_text()
        assert '"build", "native"' in src and "makedirs" in src
        port = _undo_build_dir(port)
    assert ast.dump(port) == ast.dump(_body(JAX_DIR / f"{name}.py"))
    assert not (PORT_DIR / "reference_mdp.py").exists()
    assert joracles.__name__ != toracles.__name__


def _hanabi_streams(pkg, config, games=4, steps=150, seed=0):
    """Rewards, dones, encodes and masks of a ``RecordingOracle`` and
    ``RulesHanabi`` pair from ``pkg``, playing legal moves drawn from one
    numpy stream."""
    hanabi = __import__(f"{pkg}.oracles.hanabi", fromlist=["Counter"])
    rules = __import__(f"{pkg}.oracles.hanabi_rules", fromlist=["RulesHanabi"])
    cfg = __import__(f"{pkg}.envs.hanabi", fromlist=["CONFIGS"]).CONFIGS[config]
    counter = hanabi.Counter()
    pairs = []
    for _ in range(games):
        o = rules.RecordingOracle(counter, **cfg)
        pairs.append((o, rules.RulesHanabi(rules.draw_cursor(o.drawn, cfg["ranks"]),
                                           cxx_quirks=True, **cfg)))
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        for o, g in pairs:
            legal = np.nonzero(g.legal_mask(g.to_move))[0]
            uid = int(legal[rs.randint(len(legal))])
            out.append((o.cur, *o.step(uid), *g.step(uid)))
            if out[-1][2]:
                o.reset()
                g.new_game()
            else:
                out.append(tuple(np.asarray(x) for x in g.encode(g.to_move))
                           + (g.legal_mask(g.to_move), np.asarray(o.obs[g.to_move][0])))
    return out


@pytest.mark.parametrize("config", ["full", "very_small"])
def test_hanabi_oracle_pair_matches_jax(config):
    port = _hanabi_streams("madrona_rl_envs_playground_tpu_torch", config)
    jax_ = _hanabi_streams("madrona_rl_envs_playground_tpu", config)
    assert len(port) == len(jax_) and any(len(x) == 5 and x[2] for x in port)
    for a, b in zip(port, jax_):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _overcooked_stream(pkg, variant, steps=300, seed=0):
    layouts = __import__(f"{pkg}.envs.layouts", fromlist=["get_base_layout_params"])
    oracle = __import__(f"{pkg}.oracles.overcooked", fromlist=["OvercookedOracle"])
    params = layouts.get_base_layout_params("cramped_room", 50, variant=variant)
    o = oracle.OvercookedOracle(variant, params)
    rs = np.random.RandomState(seed)
    out = [o.reset()]
    for _ in range(steps):
        obs, rew, done = o.step([int(a) for a in rs.randint(0, 6, size=o.P)])
        out += [obs, np.asarray(rew), np.asarray(done)]
        if done:
            out.append(o.reset())
    return out


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_overcooked_oracle_matches_jax(variant):
    port = _overcooked_stream("madrona_rl_envs_playground_tpu_torch", variant)
    jax_ = _overcooked_stream("madrona_rl_envs_playground_tpu", variant)
    assert len(port) == len(jax_) > 900  # six episodes of 50 steps
    for x, y in zip(port, jax_):
        np.testing.assert_array_equal(x, y)


def native_oracle():
    """The port's native module with its library built, under a lock: test
    files running in parallel build it once."""
    from madrona_rl_envs_playground_tpu_torch.oracles import native

    lib_dir = Path(native._LIB_PATH).parent
    lib_dir.mkdir(parents=True, exist_ok=True)
    with open(lib_dir / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        native._load()
    return native


def test_native_oracle_builds_under_build_and_matches_jax(tmp_path, monkeypatch):
    """JAX's binding builds its own library here, into a temporary directory
    (its ``_build`` writes wherever ``_LIB_PATH`` points), so that this test
    never writes into ``native/`` while JAX's own tests may read it."""
    from madrona_rl_envs_playground_tpu.envs.layouts import get_base_layout_params
    from madrona_rl_envs_playground_tpu.oracles import native as jnative

    monkeypatch.setattr(jnative, "_LIB_PATH", str(tmp_path / "libovercooked_oracle.so"))
    monkeypatch.setattr(jnative, "_lib", None)
    native = native_oracle()
    lib = Path(native._LIB_PATH)
    assert lib.parent == REPO / "build" / "native" and lib.is_file()
    for variant in ("v1", "v2"):
        params = get_base_layout_params("cramped_room", 30, variant=variant)
        port = native.NativeOvercookedOracle(variant, params, batch=64)
        ref = jnative.NativeOvercookedOracle(variant, params, batch=64)
        np.testing.assert_array_equal(port.reset(), ref.reset())
        rs = np.random.RandomState(1)
        dones = 0
        for _ in range(100):
            a = rs.randint(0, 6, size=(64, 2)).astype(np.int32)
            got, want = port.step(a), ref.step(a)
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
            dones += int(got[2].sum())
        assert dones == 64 * 3  # every env reset at its 30-step horizon
    assert os.path.realpath(native._NATIVE_DIR) == str(REPO / "native")
