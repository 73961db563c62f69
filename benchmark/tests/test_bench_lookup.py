"""The harness finds every cell, configuration, traffic mix, limit file and
metric reader by the names BENCHMARK.json gives, and BENCHMARK.json keeps to
the form the benchmark's contract sets."""

import json
import os
import re

import pytest

from fpbench import cell as cell_mod

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    c = cell_mod.Cell(BENCH, w["name"])
    assert c.config["name"] == w["config"]
    for hook in ("make_inputs", "Client", "judge", "summarize", "reference"):
        assert hasattr(c.kind, hook), hook
    assert c.limits and all(isinstance(v, float) for v in c.limits.values())
    assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.end_to_end:
        assert callable(c.e2e_reader(m["name"]))
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))
    assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    with open(os.path.join(ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert c["file"].startswith("benchmark/configs/")
    assert os.path.exists(os.path.join(BENCH, "controls", cfg["control"] + ".py"))


def test_names_and_units():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]] + [c["name"] for c in SPEC["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    ends = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in ends and set(m.get("workloads", cells)) <= cells
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_files_found_by_whole_name_or_its_first_part(tmp_path):
    for folder in ("metrics", "e2e"):
        d = tmp_path / folder
        d.mkdir()
        (d / "q.py").write_text("def read(r):\n    return 1\n")
        (d / "q.b.py").write_text("def read(r):\n    return 2\n")
        assert cell_mod.load_module(str(tmp_path), folder, "q.a").read(None) == 1
        assert cell_mod.load_module(str(tmp_path), folder, "q.b").read(None) == 2


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cell_mod.Cell(BENCH, "no.such.cell")
