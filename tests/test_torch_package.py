"""The port stands alone: it imports neither JAX nor the JAX package, ships
its kernel sources, and its chip smoke refuses to run without a card.

Each check runs in a fresh interpreter, because this test process has JAX
loaded already (``tests/conftest.py``).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "madrona_rl_envs_playground_tpu_torch"

_BLOCK_JAX = textwrap.dedent("""
    import importlib, pkgutil, sys

    class _Blocked:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "madrona_rl_envs_playground_tpu"):
                raise ImportError(f"the port imported {name}")
            return None

    sys.meta_path.insert(0, _Blocked())
    import madrona_rl_envs_playground_tpu_torch as port
    names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    assert not any(m.split(".")[0] in ("jax", "madrona_rl_envs_playground_tpu")
                   for m in sys.modules)
    print(len(names))
""")


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, text=True,
                          capture_output=True, timeout=120)


def test_port_imports_no_jax():
    r = _run(["-c", _BLOCK_JAX], cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20  # every module of the slice was imported


def test_port_sources_import_no_jax():
    """Also covers imports inside functions, which the import test above
    does not run, ``chip_smoke.py`` and the port's scripts."""
    scripts = sorted((REPO / "scripts").glob("torch_*.py"))
    assert scripts
    for f in sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + scripts:
        for line in f.read_text().splitlines():
            code = line.split("#")[0]
            words = code.replace(",", " ").split()
            if "import" in words or "from" in words:
                tops = {w.split(".")[0] for w in words}
                assert not tops & {"jax", "jaxlib", "flax", "optax",
                                   "madrona_rl_envs_playground_tpu"}, f"{f}: {line}"


def test_kernels_build_from_csrc_into_an_ignored_directory(tmp_path, monkeypatch):
    """Each source builds into the ignored build/kernels/, named by a digest
    of the source, the shared headers and the flags: an edited header
    (csrc/episode_scan.cuh) changes every library's path, so no stale
    library is loaded."""
    import shutil

    from madrona_rl_envs_playground_tpu_torch.ops import _build

    names = ("overcooked", "cartpole", "balance", "hanabi", "acrobot")
    for name in names:
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert _build.library_path(name).parent == REPO / "build" / "kernels"
    assert (_build.CSRC / "episode_scan.cuh").is_file()
    assert "build/" in (REPO / ".gitignore").read_text().splitlines()

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in names}
    assert before == {n: _build.library_path(n) for n in names}  # stable
    header = csrc / "episode_scan.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert all(_build.library_path(n) != after[n] for n in names)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA, and alone in a directory, it exits nonzero with no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run([str(REPO / "chip_smoke.py")], cwd=REPO, env=env)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    r = _run([str(alone)], cwd=tmp_path, env=env)
    assert r.returncode != 0 and '"ok"' not in r.stdout
