"""K4's envelope check, which runs on the card: its table, the envelope word
it fills when a launch is refused, and the report the host raises.

``chip_smoke.py`` (``phase_hanabi_envelope``) drives a refused launch on the
card; here the table is held against ``rollout_envelope`` and against every
state JAX's env reaches, and a word built as the kernel builds it (each
row's min and max over the batch, the bitmask of the rows outside) must
give exactly the text ``envelope_violations`` gives for the same state.
Everything is integer, so every comparison is exact.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_rl_envs_playground_tpu.core.batch import batched_reset as j_reset
from madrona_rl_envs_playground_tpu.core.batch import batched_step as j_step
from madrona_rl_envs_playground_tpu.envs import hanabi as jh
from madrona_rl_envs_playground_tpu.ops import hanabi_megakernel as jk
from madrona_rl_envs_playground_tpu_torch.envs import hanabi as th
from madrona_rl_envs_playground_tpu_torch.ops import hanabi as tk

CPU = torch.device("cpu")
CONFIGS = ("full", "small", "very_small")
SOURCE = Path(tk.__file__).resolve().parents[1] / "csrc" / "hanabi.cu"
# rows of the scalar block that the envelope bounds, pushed past them
SCAL_EDGES = ("deck_size", "info_tokens", "life_tokens", "cur_player", "turns_to_play", "score")


def word_of(env, st: np.ndarray) -> torch.Tensor:
    """The envelope word K4's refused launch writes for the state ``st``
    ([ROWS, N] int32), built here with numpy: the flag, the bitmask of the
    rows whose min or max leaves (lo, hi), every row's min, every row's
    max."""
    lo, hi = (x.numpy() for x in tk.rollout_envelope(env))
    mn, mx = st.min(axis=1).astype(np.int64), st.max(axis=1).astype(np.int64)
    rows = st.shape[0]
    bits = np.zeros((rows + 31) // 32, np.uint32)
    for r in np.nonzero((mn < lo) | (mx > hi))[0]:
        bits[r // 32] |= np.uint32(1) << np.uint32(r % 32)
    word = np.concatenate([[1], bits.view(np.int32), mn, mx]).astype(np.int32)
    assert word.size == tk.envelope_word_ints(env)
    return torch.from_numpy(word)


def pushed_state(env, n: int, seed: int):
    """``n`` fresh games with values pushed outside the envelope in rows
    across the state (a deck card, a discard count, a firework, the bounded
    scalars, a hand card, a hand size, a known colour and a known rank, the
    last past bit 128 of the bitmask in the full config), each in one env
    drawn from ``seed``, to its low or its high side."""
    ts, _ = tk.init_packed(env, n, device=CPU)
    st = ts.st.clone()
    off, (lo, hi) = tk.row_offsets(env), tk.rollout_envelope(env)
    rs = np.random.RandomState(seed)
    rows = [off["deck"] + 3, off["disc"] + 1, off["fw"], off["hc"] + 7, off["hs"] + 1,
            off["kc"] + 2, off["rows"] - 1]
    rows += [off["scal"] + tk.SCAL_FIELDS.index(f) for f in SCAL_EDGES]
    for r in rows:
        w, up = rs.randint(n), rs.randint(2)
        st[r, w] = int(hi[r]) + 1 + rs.randint(100) if up else int(lo[r]) - 1 - rs.randint(100)
    return st, rows


@pytest.mark.parametrize("config", CONFIGS)
def test_envelope_table_equals_rollout_envelope(config):
    """The table K4 reads (``envelope_table``, int32 [2 * ROWS]: the lows,
    then the highs) holds ``rollout_envelope``'s bounds row for row; rows
    with no bound hold the whole int32 range, which no value leaves."""
    env = th.Env(**th.CONFIGS[config])
    lo, hi = tk.rollout_envelope(env)
    tab = tk.envelope_table(env, "cpu")
    rows = tk.row_offsets(env)["rows"]
    assert tab.dtype == torch.int32 and tab.shape == (2 * rows,)
    assert torch.equal(tab[:rows].long(), lo) and torch.equal(tab[rows:].long(), hi)
    assert tk.envelope_table(env, "cpu") is tab  # built once per device
    free = (lo == -2**31) & (hi == 2**31 - 1)
    scal = tk.row_offsets(env)["scal"]
    last_move = [scal + tk.SCAL_FIELDS.index(f) for f in tk.SCAL_FIELDS if f.startswith("lm_")]
    assert free[last_move].all() and free[tk.row_offsets(env)["hp"]]


@pytest.mark.parametrize("config,seed", [("full", 0), ("small", 1), ("very_small", 2)])
def test_jax_states_lie_inside_the_envelope_table(config, seed):
    """Every state JAX's env reaches over 150 legal moves, through resets
    and the empty-deck shift (half the envs never play while another move
    is legal), packed as JAX's kernel packs it, lies inside the table K4
    checks: the card never refuses a state of the reference."""
    je, te = jh.Env(**jh.CONFIGS[config]), th.Env(**th.CONFIGS[config])
    n, steps = 32, 150
    tab = tk.envelope_table(te, "cpu").numpy()
    rows = tab.size // 2
    names = ("deck", "disc", "fw", "scal", "hc", "hp", "hs", "kc", "kr")
    reset, step = jax.jit(j_reset, static_argnums=(0, 1, 2)), jax.jit(j_step, static_argnums=(0,))
    bs, out = reset(je, n, 0)
    rs = np.random.RandomState(seed)
    H, resets = te.hand, 0
    for t in range(steps):
        d = jk.pack_state(je, bs.env_states)
        st = np.concatenate([np.asarray(d[k]) for k in names])
        assert st.shape == (rows, n)
        inside = (st >= tab[:rows, None]) & (st <= tab[rows:, None])
        assert inside.all(), (t, np.nonzero(~inside.all(1))[0])
        mask = np.asarray(out.action_mask)
        acts = np.zeros((n, te.players), np.int32)
        for i in range(n):
            for p in range(te.players):
                legal = np.nonzero(mask[i, p])[0]
                careful = [u for u in legal if not (H <= u < 2 * H)]
                pick = careful if i >= n // 2 and careful else legal
                acts[i, p] = rs.choice(pick) if len(pick) else 0
        bs, out = step(je, bs, jnp.asarray(acts))
        resets += int(np.asarray(out.done).sum())
    assert resets > 0


@pytest.mark.parametrize("config,seed", [("full", 0), ("full", 1), ("small", 2),
                                         ("very_small", 3)])
def test_word_report_equals_envelope_violations(config, seed):
    """A word filled as K4's refused launch fills it gives exactly the text
    ``envelope_violations`` gives for the same out-of-range state, row by
    row in row order, and names every pushed row; a state inside gives
    none."""
    env = th.Env(**th.CONFIGS[config])
    st, rows = pushed_state(env, 64, seed)
    want = tk.envelope_violations(env, st)
    assert len(want) == len(rows)
    assert want == tk.word_violations(env, word_of(env, st.numpy()))
    assert any(t.startswith("life_tokens: ") for t in want)
    assert any(t.startswith("kr[") for t in want)
    fresh, _ = tk.init_packed(env, 64, device=CPU)
    assert tk.envelope_violations(env, fresh.st) == []
    assert tk.word_violations(env, word_of(env, fresh.st.numpy())) == []


def test_violation_text_names_fields():
    """The formatter's ``"field[i]: min..max"``: scalar rows by their field
    name, the other blocks by block and index."""
    env = th.Env(**th.CONFIGS["full"])
    off = tk.row_offsets(env)
    life = off["scal"] + tk.SCAL_FIELDS.index("life_tokens")
    rows = [off["deck"] + 4, life, off["kr"] + 9]
    mn, mx = list(range(off["rows"])), [r + 1000 for r in range(off["rows"])]
    assert tk.violation_text(env, rows, mn, mx) == [
        f"deck[4]: {off['deck'] + 4}..{off['deck'] + 1004}", f"life_tokens: {life}..{life + 1000}",
        f"kr[9]: {off['kr'] + 9}..{off['kr'] + 1009}"]


def test_check_rollout_envelope_quiet_without_a_refusal():
    """Nothing refused on the device: the check returns quietly (on the CPU
    no K4 launches, so there is never a word)."""
    assert tk.check_rollout_envelope("cpu") is None
    assert not any(d.type == "cpu" for _, d in tk._ENVELOPE_WORDS)


def test_check_rollout_envelope_raises_once_on_a_filled_word(monkeypatch):
    """A filled word (one the card wrote, here built on the host) raises
    ``ValueError`` with the prefix and ``envelope_violations``' text, at the
    check and at the next launch's read (``_raise_refused`` without a
    wait), then is cleared: the next check returns quietly."""
    env = th.Env(**th.CONFIGS["full"])
    st, _ = pushed_state(env, 16, 7)
    text = "; ".join(tk.envelope_violations(env, st))
    for wait in (True, False):
        word = tk.EnvelopeWord(env, word_of(env, st.numpy()), device_ptr=0)
        monkeypatch.setitem(tk._ENVELOPE_WORDS, (tk._config_key(env), CPU), word)
        assert word.flag.value == 1
        with pytest.raises(ValueError) as err:
            tk._raise_refused(CPU, wait=wait)
        assert str(err.value) == tk.ENVELOPE_ERROR + text
        assert "life_tokens: " in str(err.value)
        assert word.flag.value == 0 and not word.words.any()
        tk.check_rollout_envelope("cpu")
    # an unfilled word is left alone
    word = tk.EnvelopeWord(env, torch.zeros(tk.envelope_word_ints(env), dtype=torch.int32), 0)
    monkeypatch.setitem(tk._ENVELOPE_WORDS, (tk._config_key(env), CPU), word)
    tk._raise_refused(CPU, wait=False)
    tk.check_rollout_envelope("cpu")


@pytest.mark.parametrize("name,value", [("REFUSED_DCNT", "-1"), ("REFUSED_CHK", "INT32_MIN")])
def test_refused_outputs_match_the_kernel_source(name, value):
    """The refused launch's outputs the wrapper documents are the kernel's
    constants, and the word's size its ``envelope_ints``."""
    src = SOURCE.read_text()
    assert re.search(rf"constexpr int(32_t)? {name} = {re.escape(value)};", src)
    assert getattr(tk, name) == (-1 if value == "-1" else -2**31)
    assert "return 1 + envelope_bitmask_words(rows) + 2 * rows;" in src
    assert "(rows + 31) / 32" in src
