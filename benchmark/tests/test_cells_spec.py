"""BENCHMARK.json against the benchmark's contract, and the files each of
its names resolves to; a cell, a traffic kind and a metric added as files
in another directory load and run with no edit, on one device or two."""

import json
import os
import re
import shutil
import types

import numpy as np
import torch

from benchmark import run as brun
from benchmark.harness import spec as S

SPEC = S.load_spec()
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_cells_spec_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["command"]) <= 32
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert os.path.isdir(os.path.join(S.REPO, p))
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["configs"]) <= 24
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert 1 <= len(SPEC["per_layer"]) <= 128
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_cells_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(set(names)) == len(names)
    for n in names:
        assert S.NAME.fullmatch(n), n
    for w in SPEC["workloads"]:
        assert S.NAME.fullmatch(w["config"]) and S.NAME.fullmatch(
            w["traffic"])
        assert TEXT.fullmatch(w["why"])
    for c in SPEC["configs"]:
        assert all(S.NAME.fullmatch(k) for k in c["reduced"])
        assert TEXT.fullmatch(c["source"]) and TEXT.fullmatch(c["why"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert S.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert TEXT.fullmatch(m["layer"])
    for word in SPEC["command"]:
        assert TEXT.fullmatch(word) and not word.startswith("/")


def test_cells_resolve_to_their_files():
    from rambl_tpu_torch.config import PipelineConfig

    for c in SPEC["configs"]:
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        cfg = S.read_json(c["file"])
        assert {"panel", "sample", "settings", "assumed"} <= set(cfg)
        PipelineConfig(**cfg["settings"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    e2e_names = {m["name"] for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        S.config_entry(SPEC, w["config"])
        with open(S.traffic_file(w["traffic"])) as f:
            traffic = json.load(f)
        assert callable(S.runner(traffic["kind"]))
        e2e = {m["name"] for m in S.metrics_of(SPEC, w["name"])}
        assert "setup_s" in e2e and traffic["rate_metric"] in e2e
        assert len(e2e) >= 2
        layer = S.layer_metrics_of(SPEC, w["name"])
        assert layer
        assert all(m["moves"] in e2e for m in layer)
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e_names
        assert callable(S.reader(m["name"]))
        for w in m.get("workloads", []):
            S.cell(SPEC, w)
    for m in SPEC["end_to_end"]:
        for w in m.get("workloads", []):
            S.cell(SPEC, w)


TINY = {
    "panel": {"n_species": 5, "refs_per_species": 2, "leaf_per_ref": False,
              "ref_len_max": 2048, "panel_seed": 3},
    "sample": {"n_reads": 1500, "abundance_sigma": 1.0, "read_len": 100,
               "read_len_max": 128, "sub_error": 0.004,
               "indel_error": 0.0005},
    "settings": {"batch_size": 512, "max_genes": 16, "sw_rows": 104},
    "assumed": ["a tiny panel for tests"],
}


def test_cells_extra_cell_and_metric_from_files(tmp_path, db_cache):
    """A cell, its configuration, its traffic, its traffic kind and a
    per-layer metric that exist only as files and entries in another
    directory run with no edit to the benchmark's code."""
    root = tmp_path / "root"
    bench = root / "benchmark"
    for sub in ("configs", "workloads", "kinds", "metrics"):
        (bench / sub).mkdir(parents=True)
    (bench / "configs" / "tiny.json").write_text(json.dumps(TINY))
    shutil.copy(S.traffic_file("stream"), bench / "workloads" / "again.json")
    shutil.copy(S.kind_file("stream"), bench / "kinds" / "stream.py")
    (bench / "metrics" / "extra.reads_per_busy_s.py").write_text(
        "def read(rec):\n"
        "    return rec['work'] / rec['busy_s'] if rec['busy_s'] else None\n")
    spec = dict(SPEC)
    spec["configs"] = SPEC["configs"] + [dict(
        name="tiny", source="tests", file="benchmark/configs/tiny.json",
        reduced=[], why="tests")]
    spec["workloads"] = SPEC["workloads"] + [dict(
        name="tiny.again", config="tiny", traffic="again", chips=1,
        why="tests")]
    spec["end_to_end"] = [dict(m, workloads=m["workloads"] + ["tiny.again"])
                          if m["name"] == "reads_per_s" else m
                          for m in SPEC["end_to_end"]]
    spec["per_layer"] = SPEC["per_layer"] + [dict(
        name="extra.reads_per_busy_s", unit="reads/s", better="higher",
        source="device_trace", layer="tests", moves="reads_per_s",
        workloads=["tiny.again"])]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    found = S.layer_metrics_of(spec, "tiny.again")
    assert [m["name"] for m in found] == ["extra.reads_per_busy_s"]
    read = S.reader("extra.reads_per_busy_s", str(bench))
    assert read(dict(work=10, busy_s=2.0)) == 5.0

    args = types.SimpleNamespace(workload="tiny.again", seed=2 ** 31 + 5,
                                 seconds=0.0, trace=0, control=0)
    line = brun.run(args, torch.device("cpu"), root=str(root),
                    log=lambda m: None)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"reads_per_s", "peak_gb", "setup_s"}
    assert line["attempted"] == TINY["sample"]["n_reads"]
    assert list(line)[-1] == "compared"
    assert all(v["value"] == 0 for v in line["compared"].values())
    assert np.isfinite(line["metrics"]["reads_per_s"]["value"])


KIND_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kinds",
                         "cards.py")


def cards_root(tmp_path, chips: int, config: dict) -> str:
    """A directory holding BENCHMARK.json with a cell `cards.load` of
    `chips` cards, and its configuration, traffic, traffic kind (the test
    kind `kinds/cards.py`) and a per-layer metric as files of its own."""
    root = tmp_path / "root"
    bench = root / "benchmark"
    for sub in ("configs", "workloads", "kinds", "metrics"):
        (bench / sub).mkdir(parents=True)
    (bench / "configs" / "cards.json").write_text(json.dumps(config))
    (bench / "workloads" / "load.json").write_text(json.dumps(
        {"kind": "cards", "rate_metric": "steps_per_s", "unit": "steps"}))
    shutil.copy(KIND_FILE, bench / "kinds" / "cards.py")
    (bench / "metrics" / "cards.idle_share.py").write_text(
        "def read(rec):\n"
        "    return 100.0 * (1.0 - rec['busy_s'] / rec['window_s'])\n")
    spec = dict(SPEC)
    spec["configs"] = [dict(name="cards", source="tests",
                            file="benchmark/configs/cards.json", reduced=[],
                            why="tests")]
    spec["workloads"] = [dict(name="cards.load", config="cards",
                              traffic="load", chips=chips, why="tests")]
    spec["end_to_end"] = [
        dict(name="steps_per_s", unit="steps/s", better="higher", bound=0.25,
             source="host_clock"),
        dict(name="peak_gb", unit="GB", better="lower", bound=0.01,
             source="host_clock"),
        dict(name="setup_s", unit="s", better="lower", bound=0.25,
             source="host_clock")]
    spec["per_layer"] = [dict(name="cards.idle_share", unit="%",
                              better="lower", source="device_trace",
                              layer="tests", moves="steps_per_s")]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(root)


def test_cells_extra_kind_on_two_devices_from_files(tmp_path, monkeypatch):
    """A cell of two devices whose traffic kind, configuration and traffic
    exist only as files under another root runs through `run.run` on two
    devices, and its runner's `Context` holds both."""
    root = cards_root(tmp_path, 2, {"alloc_bytes": 1000, "adds": 3})
    seen = []
    real = S.runner

    def runner(kind, bench_dir=S.BENCH_DIR):
        assert bench_dir == os.path.join(root, "benchmark")
        cls = real(kind, bench_dir)
        return lambda ctx: seen.append(ctx) or cls(ctx)

    monkeypatch.setattr(S, "runner", runner)
    args = types.SimpleNamespace(workload="cards.load", seed=2 ** 31 + 6,
                                 seconds=0.0, trace=0, control=0)
    line = brun.run(args, ["cpu"] * 2, root=root, log=lambda m: None)
    assert [c.devices for c in seen] == [(torch.device("cpu"),) * 2]
    assert seen[0].device == torch.device("cpu")
    assert line["correct"] is True
    assert line["compared"] == {"cards_differing": {"value": 0, "limit": 0}}
    assert line["attempted"] == 1
    assert line["device"]["count"] == 2
    assert set(line["metrics"]) == {"steps_per_s", "peak_gb", "setup_s"}
    # a runner that leaves a card out reads not correct
    bad = tmp_path / "bad"
    shutil.copytree(root, bad)
    kind = bad / "benchmark" / "kinds" / "cards.py"
    kind.write_text(kind.read_text().replace("for b in self.held:",
                                             "for b in self.held[:1]:"))
    seen.clear()
    monkeypatch.setattr(S, "runner", real)
    line = brun.run(args, ["cpu"] * 2, root=str(bad), log=lambda m: None)
    assert line["correct"] is False
    assert line["compared"]["cards_differing"]["value"] == 1
