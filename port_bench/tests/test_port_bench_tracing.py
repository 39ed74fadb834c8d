"""The readers of the program's own spans (``metrics/*`` over
``metrics_tracing.py``) on synthetic snapshots, and the tracer
(``madrona_rl_envs_playground_tpu_torch/utils/tracing.py``) on the card.

The synthetic snapshots hold a captured (first) update whose numbers would
move every median if it were counted, then three replayed updates; the
same snapshots without device times read None everywhere, as does a
program without the tracer.  The ``card`` tests capture a tiny self-play
trainer and a tiny MAPPO runner and check every replayed update's device
times, the graphs' counters, that no event is taken while a graph is
captured, and that tracing adds no synchronisation to a replayed update.
"""

import copy
import warnings

import pytest
import torch

from port_bench import metrics_tracing
from port_bench.run import reader


def _update(uid, phases, replayed=True, period=None, uncovered=None):
    """An update's record as ``snapshot()`` gives it; ``phases`` are
    (name, self ms, [(child, device ms)]), one after another."""
    root = {"id": uid * 100, "name": "update", "parent": None, "update": uid}
    spans, t, k = [root], 0.0, 1
    for name, self_ms, kids in phases:
        ms = self_ms + sum(m for _, m in kids)
        ph = {"id": uid * 100 + k, "name": name, "parent": root["id"], "update": uid,
              "host_ms": ms + 0.5, "device_ms": ms, "self_ms": self_ms}
        spans.append(ph)
        k += 1
        for kid, m in kids:
            spans.append({"id": uid * 100 + k, "name": kid, "parent": ph["id"], "update": uid,
                          "host_ms": m, "device_ms": m, "self_ms": m})
            k += 1
            t += m
        t += self_ms
    root.update(host_ms=t + 1.0, device_ms=t, self_ms=0.0)
    return {"id": uid, "replayed": replayed, "period_ms": period, "uncovered_ms": uncovered,
            "spans": spans}


def _running(host_ms_by_name):
    return {name: {"host_ms": {"count": 1, "sum": ms, "min": ms, "max": ms},
                   "device_ms": None, "self_ms": None} for name, ms in host_ms_by_name.items()}


def _selfplay_snapshot():
    ups = [_update(1, [("rollout", 50.0, []), ("advantage", 9.0, []), ("epochs", 900.0, []),
                       ("metrics", 3.0, [])], replayed=False, period=2000.0, uncovered=900.0)]
    for uid, (roll, inp, eager, gap) in enumerate(
            [(12.0, 0.5, 0.45, 0.5), (13.0, 0.6, 0.55, 1.0), (14.0, 0.7, 0.65, 2.0)], start=2):
        ups.append(_update(uid, [
            ("rollout", 0.1, [("graph.inputs:rollout", 0.01), ("graph.replay:rollout",
                                                               roll - 0.11)]),
            ("advantage", eager - 0.3, [("graph.inputs:scan", 0.02),
                                        ("graph.replay:scan", 0.5)]),
            ("epochs", 0.1, [("graph.inputs:epochs", inp - 0.03),
                             ("graph.replay:epochs", 34.0 + uid)]),
            ("metrics", 0.1, []),
        ], period=50.0, uncovered=gap))
    return {"updates": ups, "others": [],
            "spans": _running({"construct": 8000.0, "update": 7500.0,
                               "graph.capture:rollout": 500.0, "graph.capture:scan": 100.0,
                               "graph.capture:epochs": 1400.0, "graph.replay:epochs": 900.0}),
            "counters": {}, "launches": {}}


def _mappo_snapshot():
    ups = [_update(1, [("collect", 200.0, []), ("buffer", 9.0, []), ("compute", 9.0, []),
                       ("train", 900.0, []), ("score_read", 1.0, [])], replayed=False)]
    for uid, (col, comp, tr) in enumerate([(33.0, 1.0, 82.0), (35.0, 3.0, 81.0),
                                           (34.0, 2.0, 84.0)], start=2):
        ups.append(_update(uid, [
            ("collect", 0.2, [("graph.inputs:collect", 0.1), ("graph.replay:collect",
                                                              col - 0.3)]),
            ("buffer", 0.3, []),
            ("compute", comp - 0.5, [("graph.inputs:returns", 0.05),
                                     ("graph.replay:returns", 0.45)]),
            ("train", 0.1, [("graph.inputs:train", 0.4), ("graph.replay:train", tr - 0.5)]),
            ("score_read", 0.05, []),
        ], period=120.0, uncovered=1.2 * uid))
    return {"updates": ups, "others": [],
            "spans": _running({"construct": 9000.0, "graph.capture:collect": 1000.0,
                               "graph.capture:returns": 200.0, "graph.capture:train": 1800.0}),
            "counters": {}, "launches": {}}


def _without_device(snap):
    snap = copy.deepcopy(snap)
    for u in snap["updates"]:
        u["period_ms"] = u["uncovered_ms"] = None
        for s in u["spans"]:
            s["device_ms"] = None
    return snap


# (reader, snapshot, value): every median taken over the replayed updates only
READINGS = [
    ("rollout_span_ms.selfplay", _selfplay_snapshot, 13.0),
    ("advantage_span_ms.selfplay", _selfplay_snapshot, 0.55 - 0.3 + 0.52),
    ("epochs_span_ms.selfplay", _selfplay_snapshot, 0.1 + 0.57 + 37.0),
    ("collect_span_ms.mappo", _mappo_snapshot, 34.0),
    ("compute_span_ms.mappo", _mappo_snapshot, 2.0),
    ("train_span_ms.mappo", _mappo_snapshot, 82.0),
    ("graph_input_ms.train", _selfplay_snapshot, 0.01 + 0.02 + 0.57),
    ("graph_input_ms.train", _mappo_snapshot, 0.55),
    ("eager_ms.train", _selfplay_snapshot, 0.55),
    ("eager_ms.train", _mappo_snapshot, 0.2 + 0.3 + 1.5 + 0.1 + 0.05),
    ("host_gap_share.train", _selfplay_snapshot, 2.0),
    ("host_gap_share.train", _mappo_snapshot, 100.0 * 3.6 / 120.0),
    ("construct_s.train", _selfplay_snapshot, 8.0),
    ("construct_s.train", _mappo_snapshot, 9.0),
    ("capture_s.train", _selfplay_snapshot, 2.0),
    ("capture_s.train", _mappo_snapshot, 3.0),
]


@pytest.mark.parametrize("name,make,want", READINGS)
def test_reader_on_a_synthetic_snapshot(name, make, want):
    mod = reader(name)
    assert mod.value(make()) == pytest.approx(want, rel=1e-9)
    assert mod.value(_without_device(make())) is None
    assert mod.value(None) is None


def test_readers_read_nothing_without_a_program_tracer(monkeypatch):
    """A checkout whose program has no tracer: every reader returns None."""
    monkeypatch.setattr(metrics_tracing, "snapshot", lambda: None)
    for name in {n for n, _, _ in READINGS}:
        assert reader(name).read({}) is None


def test_readers_read_the_process_tracer():
    """On the CPU the process's tracer holds no device time: None."""
    from madrona_rl_envs_playground_tpu_torch.utils import tracing

    tracing.reset()
    with tracing.span("update", torch.device("cpu"), update=True):
        pass
    assert metrics_tracing.snapshot() is not None
    for name in {n for n, _, _ in READINGS}:
        assert reader(name).read({}) is None


# ---- on the card ------------------------------------------------------------------

def _tiny(kind, device):
    """A tiny captured trainer, its step and its graphs."""
    if kind == "selfplay":
        from madrona_rl_envs_playground_tpu_torch.envs import overcooked
        from madrona_rl_envs_playground_tpu_torch.train.selfplay import (SelfPlayConfig,
                                                                         SelfPlayPPO)
        cfg = SelfPlayConfig(num_steps=8, hidden=16, num_layers=1, update_epochs=2,
                             num_minibatches=1, use_bf16=True)
        t = SelfPlayPPO(overcooked.make("cramped_room", horizon=400), 64, cfg, seed=1,
                        device=device)
        return t, t.train_step, [t._rollout_graph, t._scan_graph, t._update_graph]
    from madrona_rl_envs_playground_tpu_torch.envs import overcooked2
    from madrona_rl_envs_playground_tpu_torch.train.mappo import MAPPOConfig, MAPPORunner

    cfg = MAPPOConfig(episode_length=8, n_rollout_threads=16, hidden_size=16, layer_N=1,
                      ppo_epoch=2, num_mini_batch=1, seed=1)
    r = MAPPORunner(cfg, overcooked2.make("simple", horizon=200), device=device)
    return r, (lambda: r.update(0, 4)), [r._collect_graph, r._returns_graph,
                                         r.trainer._train_graph]


@pytest.mark.card
@pytest.mark.parametrize("kind", ["selfplay", "mappo"])
def test_tracer_on_the_card(card, kind, monkeypatch):
    from madrona_rl_envs_playground_tpu_torch.train.graphs import tree_leaves
    from madrona_rl_envs_playground_tpu_torch.utils import tracing

    tracing.reset()
    tracing.enable()
    taken = []
    take = tracing.TRACER._event

    def checked():
        taken.append(torch.cuda.is_current_stream_capturing())
        return take()

    monkeypatch.setattr(tracing.TRACER, "_event", checked)
    owner, step, held = _tiny(kind, card)
    step()
    names = [g.name for g in held]
    first = tracing.snapshot()["counters"]
    assert {n: first[f"captures:{n}"]["sum"] for n in names} == {n: 1 for n in names}
    for _ in range(50):
        step()
    snap = tracing.snapshot()
    assert taken and not any(taken)  # no event while a graph is captured
    c = snap["counters"]
    assert sum(v["sum"] for k, v in c.items() if k.startswith("captures:")) == len(held)
    assert [u["replayed"] for u in snap["updates"]] == [False] + [True] * 50
    for g in held:
        want = sum(t.nbytes for t in tree_leaves(g._inputs))
        assert c[f"replays:{g.name}"]["sum"] == 50
        assert c[f"input_bytes:{g.name}"]["sum"] == 50 * want
    replayed = [u for u in snap["updates"] if u["replayed"]]
    assert len(replayed) == 50
    for i, u in enumerate(replayed):
        assert all(s["device_ms"] is not None and s["device_ms"] >= 0 for s in u["spans"]), u
        assert (u["period_ms"] is None) == (i == 49)
    for r in ("rollout_span_ms.selfplay", "epochs_span_ms.selfplay") if kind == "selfplay" \
            else ("collect_span_ms.mappo", "train_span_ms.mappo"):
        assert reader(r).read({}) > 0
    for r in ("graph_input_ms.train", "eager_ms.train", "host_gap_share.train",
              "construct_s.train", "capture_s.train"):
        assert reader(r).read({}) is not None
    del owner


@pytest.mark.card
def test_tracing_adds_no_synchronisation(card):
    """Under ``torch.cuda.set_sync_debug_mode("warn")`` a replayed
    ``train_step`` warns no more with tracing on than off."""
    from madrona_rl_envs_playground_tpu_torch.utils import tracing

    trainer, step, _ = _tiny("selfplay", card)
    for _ in range(3):
        step()
    torch.cuda.synchronize()

    def warned(on):
        (tracing.enable if on else tracing.disable)()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            tracing.enable()
        torch.cuda.synchronize()
        return len(got)

    off, on = warned(False), warned(True)
    assert on <= off, (on, off)
