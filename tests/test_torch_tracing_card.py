"""The self-play trainer's epoch row counters (``utils/tracing.py``'s
``rows:epochs`` and ``active_rows:epochs``) on the card.

A captured Hanabi trainer (K3 in its rollout graph, the scan and epochs
graphs replayed): the active count's running sum stays on the card, so a
replayed ``train_step`` warns under ``torch.cuda.set_sync_debug_mode``
no more with tracing on than off, and ``snapshot()`` reads both counters
after its one synchronisation, the active rows equal to the trainable
active slots times the epochs.

Marked ``card``: skips without a CUDA device.  This file imports nothing
of the JAX package, so it runs on a machine without it:

    python -m pytest tests/test_torch_tracing_card.py -q --noconftest -p no:cacheprovider
"""

import warnings

import pytest
import torch

from madrona_rl_envs_playground_tpu_torch.envs import hanabi as t_hanabi
from madrona_rl_envs_playground_tpu_torch.train import selfplay as t_selfplay
from madrona_rl_envs_playground_tpu_torch.utils import tracing


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_row_counters_add_no_synchronisation_on_the_card(card):
    cfg = t_selfplay.SelfPlayConfig(num_steps=8, hidden=32, num_layers=2, update_epochs=4)
    trainer = t_selfplay.SelfPlayPPO(t_hanabi.Env(**t_hanabi.CONFIGS["full"]), 256, cfg,
                                     seed=5, device=card)
    assert trainer.captured
    active = []
    advantage = trainer._advantage

    def keep(*args):
        out = advantage(*args)
        active.append(out[0]["active"].sum().item())
        return out

    tracing.reset()
    trainer._advantage = keep
    for _ in range(3):
        trainer.train_step()
    del trainer._advantage
    torch.cuda.synchronize()

    def warned(on):
        (tracing.enable if on else tracing.disable)()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                trainer.train_step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            tracing.enable()
        torch.cuda.synchronize()
        return len(got)

    off, on = warned(False), warned(True)
    assert on <= off, (on, off)
    counters = tracing.snapshot()["counters"]
    rows = cfg.num_steps * 256 * 2 * cfg.update_epochs
    assert counters["rows:epochs"]["count"] == 4 and counters["rows:epochs"]["sum"] == 4 * rows
    got = counters["active_rows:epochs"]
    assert got["count"] == 4 and got["min"] is None
    # the three kept updates' counts, and the fourth's, under the rows
    assert sum(active) * cfg.update_epochs < got["sum"] < 4 * rows
    tracing.reset()
