"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
found as a file; the frozen arithmetic against the values in ``PERF.md``."""

import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PB = ROOT / "port_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def e2e_of(cell):
    return {m["name"] for m in BENCH["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def test_keys_and_names():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for e in BENCH[section]:
            assert set(e) - {"workloads"} == KEYS[section], e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_sources_and_run_length():
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24
    # a full check of 24 cells: 2 + 14 runs a cell of run_seconds + 60 s each,
    # 2 x 90 s a cell to compile and 1,200 s spare fit 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)


def test_every_per_layer_metric_moves_what_its_cells_report():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in e2e_of(cell), (m["name"], cell)
    for cell in cells:
        assert "setup_s" in e2e_of(cell) and len(e2e_of(cell)) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in BENCH["per_layer"])


def test_files_found_by_name():
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    used = set()
    for w in BENCH["workloads"]:
        wl = json.loads((PB / "workloads" / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"] and w["config"] in configs
        assert wl["driver"] == w["traffic"]
        assert (PB / "drivers" / f"{wl['driver']}.py").exists()
        assert all(isinstance(v, (int, float)) for v in wl["limits"].values())
        used.add(w["config"])
    assert used == set(configs)
    for m in BENCH["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_frozen_arithmetic_matches_perf_md():
    from port_bench import yardstick as y

    # the flagship's 520 -> 64 -> 64 -> 6 actor and -> 1 critic
    per_row = y.mlp_epoch_flop([520, 64, 64, 6]) + y.mlp_epoch_flop([520, 64, 64, 1])
    assert per_row == 318_080
    flop = y.selfplay_update_flop([[520, 64, 64, 6], [520, 64, 64, 1]], 8192 * 2 * 64, 4)
    assert math.isclose(flop / 1e12, 1.4918, abs_tol=1e-4)
    # cramped_room: 20 cells, 2 players, 520 obs bytes a seat
    assert math.isclose(y.overcooked_step_bound_ms(20, 2, 520, 8192), 0.003054, abs_tol=1e-6)
    assert y.bound(*y.overcooked_step_work(20, 2, 520, 8192))[1] == "bytes"
    assert math.isclose(y.overcooked_rollout_bound_ms(20, 2, "v1", 524288, 1000), 8.589232,
                        abs_tol=1e-6)


def test_trace_reduction():
    from port_bench import yardstick as y

    dev = [("k", 0.0, 10.0), ("k", 12.0, 20.0), ("m", 50.0, 60.0), ("pad", -50.0, -40.0)]
    host = [("update", 0.0, 100.0), ("read", 21.0, 49.0)]
    red = y.reduce_trace(dev, host, (0.0, 100.0))
    assert math.isclose(red["busy_s"], 28e-6) and math.isclose(red["window_s"], 100e-6)
    assert set(red["ops"]) == {"k", "m"} and red["ops"]["k"]["count"] == 2
    # 20-50 us idle while the host reads, 60-100 us under the update, and
    # 10-12 us too short to name
    assert math.isclose(red["idle"]["read"], 30e-6)
    assert math.isclose(red["idle"]["update"], 40e-6)
    assert math.isclose(sum(red["idle"].values()), 72e-6)


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for w in BENCH["workloads"]:
        p = subprocess.run([sys.executable, str(PB / "run.py"), "--workload", w["name"],
                            "--seed", "1", "--seconds", "1", "--trace", "0"],
                           cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout.strip() == "", w["name"]
