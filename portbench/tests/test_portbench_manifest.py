"""BENCHMARK.json against the format the benchmark keeps to: names, units,
metrics and their arrows, and the files each entry names."""

import json
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in MANIFEST["paths"])
    assert len(MANIFEST["command"]) <= 32
    assert all(_text(w) for w in MANIFEST["command"])


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names), names
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _text(w["why"])


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_each_arrow_is_reported_in_every_cell_it_lists():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = [w["name"] for w in MANIFEST["workloads"]]
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"])
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells), (m["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    cells = [w["name"] for w in MANIFEST["workloads"]]
    for cell in cells:
        e2e = [m["name"] for m in MANIFEST["end_to_end"]
               if cell in m.get("workloads", cells)]
        layer = [m for m in MANIFEST["per_layer"]
                 if cell in m.get("workloads", cells)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


def test_files_each_entry_names_exist():
    bench = ROOT / "portbench"
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("portbench/") and (ROOT / f).is_file()
        cfg = json.loads((ROOT / f).read_text())
        assert (bench / "generators" / f"{cfg['generator']}.py").is_file()
        assert (bench / "reference" / f"{cfg['reference']}.py").is_file()
    used = set()
    for w in MANIFEST["workloads"]:
        spec = json.loads((bench / "workloads" /
                           f"{w['name']}.json").read_text())
        assert spec["layers"] and all(
            (bench / "layers" / f"{slug}.json").is_file()
            for slug in spec["layers"])
        traffic = json.loads((bench / "traffic" /
                              f"{w['traffic']}.json").read_text())
        assert (bench / "drivers" / f"{traffic['driver']}.py").is_file()
        assert w["config"] in configs
        used.add(w["config"])
    for m in MANIFEST["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_layer_names_are_those_of_perf_md():
    """Each metric's layer is named, letter for letter, in the first
    column of PERF.md's table of layers; each layer file names one."""
    text = (ROOT / "PERF.md").read_text()
    section = text[text.index("## 3. Layers"):text.index("## 4.")]
    rows = {line.split("|")[1].strip() for line in section.splitlines()
            if line.startswith("| ") and not line.startswith("| Layer")}
    assert {m["layer"] for m in MANIFEST["per_layer"]} <= rows
    bench = ROOT / "portbench"
    for p in (bench / "layers").glob("*.json"):
        assert json.loads(p.read_text())["name"] in rows, p
