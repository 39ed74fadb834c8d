"""The port's tracer (``utils/tracing.py``) on the CPU.

Spans' nesting, update ids and self times on synthetic clocks; the trainers'
``update`` spans tiled by their phases, with no tensor operation outside a
phase (a ``TorchFunctionMode`` names the innermost span of every call); the
graphs' spans and counters through ``tests/test_torch_graphs.py``'s
``CPUGraph``; the device path's bookkeeping (events from a pool, device
durations, starts, self times, the period between updates) with a fake
``torch.cuda.Event`` on a fake device clock; the ring's cap; ``disable``;
and the ``record_function`` ranges a profiler sees.  The card's own events
are checked in ``port_bench/tests/test_port_bench_tracing.py``.
"""

import threading

import pytest
import torch
from torch.overrides import TorchFunctionMode

from madrona_rl_envs_playground_tpu_torch.envs import overcooked as t_oc
from madrona_rl_envs_playground_tpu_torch.envs import overcooked2 as t_oc2
from madrona_rl_envs_playground_tpu_torch.train import mappo as tm
from madrona_rl_envs_playground_tpu_torch.train import selfplay as t_selfplay
from madrona_rl_envs_playground_tpu_torch.train.mappo import runner as t_runner
from madrona_rl_envs_playground_tpu_torch.utils import tracing

from .test_torch_graphs import CPUGraph

SELFPLAY_PHASES = ["rollout", "advantage", "epochs", "metrics"]
MAPPO_PHASES = ["collect", "buffer", "compute", "train", "score_read"]


@pytest.fixture
def tracer():
    """The process's tracer, emptied and on; emptied again afterwards."""
    tracing.reset()
    tracing.enable()
    yield tracing.TRACER
    tracing.enable()
    tracing.reset()


def _selfplay(seed=1):
    cfg = t_selfplay.SelfPlayConfig(num_steps=6, hidden=16, num_layers=1, update_epochs=2,
                                    num_minibatches=2)
    return t_selfplay.SelfPlayPPO(t_oc.make("cramped_room", horizon=6), 3, cfg, seed=seed,
                                  device="cpu")


def _mappo():
    cfg = tm.MAPPOConfig(episode_length=6, n_rollout_threads=3, hidden_size=16, layer_N=1,
                         ppo_epoch=2, num_mini_batch=2, seed=2)
    return tm.MAPPORunner(cfg, t_oc2.make("cramped_room", horizon=5), device="cpu")


class _InnermostSpan(TorchFunctionMode):
    """Records the innermost open span of the tracer at every torch call."""

    def __init__(self, tracer):
        super().__init__()
        self.tracer, self.seen = tracer, []

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        stack = self.tracer._stack()
        self.seen.append((stack[-1].name if stack else None, getattr(func, "__name__", func)))
        return func(*args, **(kwargs or {}))


class _FakeClock:
    """``time.perf_counter_ns`` returning the given stamps in turn."""

    def __init__(self, stamps_ms):
        self._it = iter(int(ms * 1e6) for ms in stamps_ms)

    def perf_counter_ns(self):
        return next(self._it)


class _FakeEvent:
    """A CUDA event on a fake device clock: ``record`` reads ``NOW[0]``."""

    NOW = [0.0]
    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = self.NOW[0]

    def query(self):
        return True

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda``'s event calls answered on a fake device clock."""
    _FakeEvent.NOW[0], _FakeEvent.made = 0.0, 0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(tracing.Tracer, "_stream", lambda self, device: None)
    return _FakeEvent.NOW


def test_spans_nest_with_parents_and_update_ids():
    tr = tracing.Tracer()
    with tr.span("run"):
        for _ in range(2):
            with tr.span("update", update=True):
                with tr.span("a"):
                    with tr.span("a1"):
                        pass
                with tr.span("b"):
                    # an update opened inside an update is a span of the outer one
                    with tr.span("update", update=True):
                        pass
    snap = tr.snapshot()
    assert [u["id"] for u in snap["updates"]] == [1, 2]
    run = snap["others"][0]
    assert run["name"] == "run" and run["update"] is None and run["parent"] is None
    for u in snap["updates"]:
        spans = {s["name"]: s for s in u["spans"][1:]}
        root = u["spans"][0]
        assert root["name"] == "update" and root["parent"] == run["id"]
        assert [s["name"] for s in u["spans"]] == ["update", "a", "a1", "b", "update"]
        assert all(s["update"] == u["id"] for s in u["spans"])
        assert spans["a"]["parent"] == spans["b"]["parent"] == root["id"]
        assert spans["a1"]["parent"] == spans["a"]["id"]
        assert u["spans"][4]["parent"] == spans["b"]["id"]
    assert snap["counters"] == {}  # spans count nothing
    assert snap["spans"]["update"]["host_ms"]["count"] == 4
    assert tr._stack() == []


def test_self_time_on_the_host_clock(monkeypatch):
    """update [0, 100] ms holds a [10, 40] (holding a1 [15, 25]) and b [50,
    90]: self times 30, 20, 10 and 40 ms."""
    tr = tracing.Tracer()
    monkeypatch.setattr(tracing, "time", _FakeClock([0, 10, 15, 25, 40, 50, 90, 100]))
    with tr.span("update", update=True):
        with tr.span("a"):
            with tr.span("a1"):
                pass
        with tr.span("b"):
            pass
    monkeypatch.undo()
    spans = {s["name"]: s for s in tr.snapshot()["updates"][0]["spans"]}
    assert {k: s["host_ms"] for k, s in spans.items()} == {"update": 100, "a": 30, "a1": 10,
                                                          "b": 40}
    assert {k: s["self_ms"] for k, s in spans.items()} == {"update": 30, "a": 20, "a1": 10,
                                                          "b": 40}
    assert all(s["device_ms"] is None for s in spans.values())
    assert tr.snapshot()["spans"]["a"]["self_ms"] == {"count": 1, "sum": 20.0, "min": 20.0,
                                                      "max": 20.0}


def test_device_clock_self_times_periods_and_the_event_pool(fake_cuda):
    """On a fake device clock each update is 0-8 ms from its start: a
    [1, 5] holding a1 [2, 3], b [5, 7]; the next update starts 10 ms after
    this one.  The events go back to the pool once read."""
    tr = tracing.Tracer()
    dev = torch.device("cuda", 0)

    def one(t0):
        fake_cuda[0] = t0
        with tr.span("update", dev, update=True):
            fake_cuda[0] = t0 + 1
            with tr.span("a", dev):
                fake_cuda[0] = t0 + 2
                with tr.span("a1", dev):
                    fake_cuda[0] = t0 + 3
                fake_cuda[0] = t0 + 5
            with tr.span("b", dev):
                fake_cuda[0] = t0 + 7
            with tr.span("host"):  # no events: covers nothing on the device
                pass
            fake_cuda[0] = t0 + 8

    for k in range(3):
        one(10.0 * k)
    snap = tr.snapshot()
    assert _FakeEvent.made == tracing.EVENT_BLOCK  # 8 events an update, from one block
    for k, u in enumerate(snap["updates"]):
        s = {x["name"]: x for x in u["spans"]}
        assert {n: s[n]["device_ms"] for n in ("update", "a", "a1", "b")} == {
            "update": 8, "a": 4, "a1": 1, "b": 2}
        assert {n: s[n]["self_ms"] for n in ("update", "a", "a1", "b")} == {
            "update": 2, "a": 3, "a1": 1, "b": 2}
        assert s["host"]["device_ms"] is None
        # the last update's period waits for the next update's start
        assert (u["period_ms"], u["uncovered_ms"]) == ((10, 2) if k < 2 else (None, None))
    assert snap["spans"]["a"]["device_ms"] == {"count": 3, "sum": 12.0, "min": 4.0, "max": 4.0}
    # every event read is back in the pool but the last update's start
    assert len(tr._free_events) == tracing.EVENT_BLOCK - 1
    one(30.0)
    assert tr.snapshot()["updates"][2]["period_ms"] == 10


def test_no_event_while_capturing(fake_cuda, monkeypatch):
    tr = tracing.Tracer()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with tr.span("update", torch.device("cuda"), update=True):
        pass
    assert _FakeEvent.made == 0
    assert tr.snapshot()["updates"][0]["spans"][0]["device_ms"] is None


def test_adjacent_spans_share_their_marks(fake_cuda):
    """A tiled update [0, 8] holds a [0, 3] and b [3, 8]; b holds ``in``
    [4, 5] and ``rep`` [5, 7], opened ``after`` it.  Six events an update
    mark the eleven ends; the durations and self times are those of
    separate events."""
    tr = tracing.Tracer()
    dev = torch.device("cuda", 0)

    def one(t0):
        fake_cuda[0] = t0
        with tr.span("update", dev, update=True, tiled=True):
            with tr.span("a", dev):
                fake_cuda[0] = t0 + 3
            with tr.span("b", dev):
                fake_cuda[0] = t0 + 4
                with tr.span("in", dev) as copied:
                    fake_cuda[0] = t0 + 5
                with tr.span("rep", dev, after=copied):
                    fake_cuda[0] = t0 + 7
                fake_cuda[0] = t0 + 8

    one(0.0)
    assert _FakeEvent.made == tracing.EVENT_BLOCK
    assert len(tr._free_events) == tracing.EVENT_BLOCK - 6
    for k in range(1, 3):
        one(10.0 * k)
    snap = tr.snapshot()
    for k, u in enumerate(snap["updates"]):
        s = {x["name"]: x for x in u["spans"]}
        assert {n: (x["device_ms"], x["self_ms"]) for n, x in s.items()} == {
            "update": (8, 0), "a": (3, 3), "b": (5, 2), "in": (1, 1), "rep": (2, 2)}
        assert (u["period_ms"], u["uncovered_ms"]) == ((10, 2) if k < 2 else (None, None))
    # each event pooled once: all back but the last update's start
    assert len(tr._free_events) == tracing.EVENT_BLOCK - 1
    assert len({id(e) for e in tr._free_events}) == len(tr._free_events)


def test_a_threads_period_runs_to_its_own_next_update(fake_cuda):
    """Two threads' updates interleave on the card; each update's period
    runs to the next update of its own thread."""
    tr = tracing.Tracer()
    dev = torch.device("cuda", 0)
    turns = {name: threading.Semaphore(0) for name in ("x", "y")}
    done = threading.Semaphore(0)

    def work(name, starts):
        for t0 in starts:
            turns[name].acquire()
            fake_cuda[0] = t0
            with tr.span("update", dev, update=True):
                fake_cuda[0] = t0 + 2
            done.release()

    threads = [threading.Thread(target=work, args=("x", (0.0, 10.0, 20.0))),
               threading.Thread(target=work, args=("y", (5.0, 12.0, 30.0)))]
    for t in threads:
        t.start()
    for name in "xyxyxy":
        turns[name].release()
        assert done.acquire(timeout=10)
    for t in threads:
        t.join(timeout=10)
    periods = [u["period_ms"] for u in tr.snapshot()["updates"]]
    assert periods == [10, 7, 10, 18, None, None]


def test_events_go_on_the_spans_device_stream(monkeypatch):
    """A span's events go on its own device's current stream, whatever
    device is current; the thread keeps the ``Stream`` it made."""
    asked, made = [], []
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentStream",
                        lambda index: asked.append(index) or (7 + index, index, 1), raising=False)
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda **kw: made.append(kw) or kw["stream_id"])
    tr = tracing.Tracer()
    assert tr._stream(torch.device("cuda", 3)) == 10
    assert tr._stream(torch.device("cuda", 3)) == 10
    assert tr._stream(torch.device("cuda")) == 7
    assert asked == [3, 3, 0]
    assert [kw["device_index"] for kw in made] == [3, 0]


def test_finished_updates_are_read_and_pooled(fake_cuda, monkeypatch):
    """A graph replayed inside an update reads the events of the earlier
    updates that the card has passed, and pools them; without replays (an
    eager trainer) an update's close reads once three wait.  One block of
    events serves any number of updates; events the card has not passed
    stay unread, never beyond the ring."""
    monkeypatch.setattr(tracing, "UPDATES_KEPT", 4)
    tr = tracing.Tracer()
    dev = torch.device("cuda")

    def updates(ks, replay=False, passed=True):
        for k in ks:
            fake_cuda[0] = 10.0 * k
            with tr.span("update", dev, update=True):
                if replay:
                    tr.graph_replayed("g", 8)
                    # all read, the last update's period too
                    assert not tr._pending or not passed
                fake_cuda[0] = 10.0 * k + 6

    updates(range(10))
    assert len(tr._pending) == 2
    updates(range(10, 14), replay=True)
    assert len(tr._pending) == 1 and _FakeEvent.made == tracing.EVENT_BLOCK
    monkeypatch.setattr(_FakeEvent, "query", lambda self: False)
    updates(range(14, 20), replay=True, passed=False)
    assert len(tr._pending) == 4  # never more than the ring holds
    snap = tr.snapshot()  # synchronises: everything kept is read
    assert [u["id"] for u in snap["updates"]] == [17, 18, 19, 20]
    assert [u["period_ms"] for u in snap["updates"]] == [10, 10, 10, None]
    assert [u["spans"][0]["device_ms"] for u in snap["updates"]] == [6, 6, 6, 6]
    # updates 14 to 16 left the ring before the card had passed them: never read
    assert snap["spans"]["update"]["device_ms"]["count"] == 17
    assert snap["counters"]["replays:g"]["sum"] == 10
    assert len(tr._pending) == 1


def test_memory_is_held_at_the_cap():
    tr = tracing.Tracer()
    for _ in range(10_000):
        with tr.span("update", update=True):
            with tr.span("a"):
                pass
            tr.graph_replayed("g", 3)
        with tr.span("outside"):
            pass
    snap = tr.snapshot()
    assert len(snap["updates"]) == tracing.UPDATES_KEPT
    assert len(snap["others"]) == tracing.OTHERS_KEPT
    assert len(tr._updates) == tracing.UPDATES_KEPT and len(tr._others) == tracing.OTHERS_KEPT
    assert snap["spans"]["a"]["host_ms"]["count"] == 10_000
    assert snap["spans"]["update"]["host_ms"]["count"] == 10_000
    assert snap["counters"]["input_bytes:g"] == {"count": 10_000, "sum": 30_000, "min": 3,
                                                 "max": 3}
    tr.reset()
    snap = tr.snapshot()
    assert snap["updates"] == [] and snap["spans"] == {} and snap["counters"] == {}


def test_a_raising_span_closes_and_leaves_the_stack_clean():
    tr = tracing.Tracer()
    with pytest.raises(ValueError):
        with tr.span("update", update=True):
            with tr.span("a"):
                raise ValueError("boom")
    assert tr._stack() == []
    snap = tr.snapshot()
    assert [s["name"] for s in snap["updates"][0]["spans"]] == ["update", "a"]
    assert all(s["host_ms"] >= 0 for s in snap["updates"][0]["spans"])
    with tr.span("update", update=True):  # the next update is a fresh one
        pass
    assert [u["id"] for u in tr.snapshot()["updates"]] == [1, 2]


def test_threads_keep_their_own_stacks():
    tr = tracing.Tracer()
    barrier = threading.Barrier(4)

    def work(name):
        for _ in range(50):
            with tr.span("update", update=True):
                barrier.wait(timeout=10)
                with tr.span(name):
                    barrier.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(f"t{i}",)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    snap = tr.snapshot()
    assert len(snap["updates"]) == 200
    for u in snap["updates"]:
        root, child = u["spans"]
        assert child["parent"] == root["id"] and child["update"] == root["update"] == u["id"]
    assert snap["spans"]["update"]["host_ms"]["count"] == 200


def test_selfplay_update_is_tiled_by_its_phases(tracer):
    trainer = _selfplay()
    mode = _InnermostSpan(tracer)
    with mode:
        for _ in range(2):
            trainer.train_step()
    snap = tracer.snapshot()
    assert len(snap["updates"]) == 2
    for u in snap["updates"]:
        root = u["spans"][0]
        assert root["name"] == "update"
        assert [s["name"] for s in u["spans"] if s["parent"] == root["id"]] == SELFPLAY_PHASES
        assert all(s["update"] == u["id"] for s in u["spans"])
        assert not u["replayed"]
    inside = [name for name, _ in mode.seen]
    assert "update" not in inside  # no operation outside a phase
    assert set(inside) - {None} == set(SELFPLAY_PHASES)
    assert [s["name"] for s in snap["others"]] == ["construct"]
    assert snap["others"][0]["parent"] is None


def test_mappo_update_is_tiled_by_its_phases(tracer):
    runner = _mappo()
    mode = _InnermostSpan(tracer)
    with mode:
        for ep in range(2):
            runner.update(ep, 4)
    snap = tracer.snapshot()
    for u in snap["updates"]:
        root = u["spans"][0]
        assert [s["name"] for s in u["spans"] if s["parent"] == root["id"]] == MAPPO_PHASES
    inside = [name for name, _ in mode.seen]
    assert "update" not in inside
    assert set(inside) - {None} == set(MAPPO_PHASES)
    assert [s["name"] for s in snap["others"]] == ["construct"]


def test_device_fields_are_none_on_the_cpu(tracer):
    trainer = _selfplay()
    trainer.train_step()
    with tracing.span("x", torch.device("cpu")):
        pass
    snap = tracer.snapshot()
    spans = [s for u in snap["updates"] for s in u["spans"]] + snap["others"]
    assert spans and all(s["device_ms"] is None for s in spans)
    assert all(u["period_ms"] is None for u in snap["updates"])
    assert all(st["device_ms"] is None for st in snap["spans"].values())


def test_graph_counters_start_at_zero_on_the_cpu(tracer):
    """Nothing is captured on the CPU: no graph counter, no replayed update,
    no graph span."""
    trainer, runner = _selfplay(), _mappo()
    assert not trainer.captured and not runner.captured
    trainer.train_step()
    runner.update(0, 4)
    snap = tracer.snapshot()
    assert not [k for k in snap["counters"] if k.split(":")[0] in ("replays", "captures",
                                                                  "input_bytes")]
    assert len(snap["updates"]) == 2 and not any(u["replayed"] for u in snap["updates"])
    assert not [n for n in snap["spans"] if n.startswith("graph.")]
    assert snap["launches"]["overcooked.fused_step"] >= 0


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The trainers' capture rule answering yes on the CPU, their graphs
    ``CPUGraph``s."""
    for mod in (t_selfplay, t_runner):
        monkeypatch.setattr(mod, "captures", lambda device, collector=None: True)
        monkeypatch.setattr(mod, "LoopGraph", CPUGraph)
    monkeypatch.setattr(tm.trainer, "LoopGraph", CPUGraph)
    return monkeypatch


@pytest.mark.parametrize("kind", ["selfplay", "mappo"])
def test_replayed_updates_time_their_graphs(tracer, cpu_graphs, kind):
    """The first update captures (a host-only ``graph.capture:<graph>``
    span each); later ones copy the inputs and replay inside their phases;
    ``input_bytes`` counts the static inputs' bytes on every replay."""
    if kind == "selfplay":
        owner = _selfplay()
        graphs_by_phase = {"rollout": "rollout", "advantage": "scan", "epochs": "epochs"}
        step = owner.train_step
        held = [owner._rollout_graph, owner._scan_graph, owner._update_graph]
    else:
        owner = _mappo()
        graphs_by_phase = {"collect": "collect", "compute": "returns", "train": "train"}
        step = lambda: owner.update(0, 4)  # noqa: E731
        held = [owner._collect_graph, owner._returns_graph, owner.trainer._train_graph]
    for _ in range(4):
        step()
    snap = tracer.snapshot()
    first, *later = snap["updates"]
    assert not first["replayed"] and all(u["replayed"] for u in later)
    names = [s["name"] for s in first["spans"]]
    assert sorted(n for n in names if n.startswith("graph.")) == sorted(
        f"graph.capture:{g}" for g in graphs_by_phase.values())
    for u in later:
        by_id = {s["id"]: s for s in u["spans"]}
        for phase, g in graphs_by_phase.items():
            kids = [s["name"] for s in u["spans"]
                    if s["parent"] is not None and by_id.get(s["parent"], {}).get("name") == phase]
            assert kids == [f"graph.inputs:{g}", f"graph.replay:{g}"], (phase, kids)
    c = snap["counters"]
    assert [u["replayed"] for u in snap["updates"]] == [False, True, True, True]
    for graph in held:
        g = graph.name
        assert c[f"captures:{g}"]["sum"] == 1 and c[f"replays:{g}"]["sum"] == 3
        want = sum(t.nbytes for t in tracing_leaves(graph._inputs))
        assert graph.input_bytes == want > 0
        assert c[f"input_bytes:{g}"] == {"count": 3, "sum": 3 * want, "min": want, "max": want}
    assert snap["spans"][f"graph.capture:{held[0].name}"]["host_ms"]["count"] == 1


def tracing_leaves(tree):
    from madrona_rl_envs_playground_tpu_torch.train.graphs import tree_leaves

    return tree_leaves(tree)


def test_other_owners_graphs_only_count(tracer, monkeypatch):
    """A graph replayed outside an update span (the agent's, the vector
    env's, MAPPO's eval) opens no span and counts its replay."""
    g = CPUGraph(lambda x: {"y": x + 1}, name="step")
    x = torch.zeros(4)
    for _ in range(3):
        g(x)
    snap = tracer.snapshot()
    assert snap["updates"] == [] and not [s for s in snap["others"]
                                          if s["name"].startswith("graph.") and
                                          s["name"] != "graph.capture:step"]
    assert snap["counters"]["replays:step"]["sum"] == 2
    assert snap["counters"]["input_bytes:step"]["sum"] == 2 * x.nbytes


def test_disable_records_nothing_and_leaves_outputs_equal(tracer):
    on, off = _selfplay(seed=3), _selfplay(seed=3)
    got_on = [{k: v.clone() for k, v in on.train_step().items()} for _ in range(2)]
    before = tracer.snapshot()
    tracing.disable()
    try:
        got_off = [{k: v.clone() for k, v in off.train_step().items()} for _ in range(2)]
        with tracing.span("update", update=True):
            tracing.graph_replayed("x", 1)
        assert not tracing.in_update()
    finally:
        tracing.enable()
    after = tracer.snapshot()
    assert len(after["updates"]) == len(before["updates"]) == 2
    assert after["counters"] == before["counters"]
    for a, b in zip(got_on, got_off):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_a_profiler_sees_the_spans_as_record_function_ranges(tracer):
    trainer = _selfplay()
    trainer.train_step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.train_step()
    names = {e.name for e in prof.events()}
    assert {"update", *SELFPLAY_PHASES} <= names
    # outside a profiler session a span opens no range
    rec = None
    with tracing.span("update", update=True) as rec:
        pass
    assert rec.profiled is None


def test_stats_and_null_span():
    s = tracing.Stats()
    assert s.as_dict() is None
    for v in (3, 1, 2):
        s.add(v)
    assert s.as_dict() == {"count": 3, "sum": 6, "min": 1, "max": 3}
    tr = tracing.Tracer()
    tr.disable()
    assert tr.span("a") is tracing._NULL
    with tr.span("a") as rec:
        assert rec is None
    assert tr.snapshot()["others"] == []
