"""BENCHMARK.json holds together: each cell reports `setup_s`, another
end-to-end metric and a per-layer metric; each per-layer metric has its
reader and moves an end-to-end metric that each of its cells reports."""

import json
import re
from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.spec import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    c = spec.load(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2, e2e
    assert c.per_layer, cell
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"], m["moves"])


def test_each_per_layer_metric_has_a_reader_and_names_its_cells():
    home = ROOT / BENCH["paths"][0]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
        assert set(m.get("workloads", CELLS)) <= set(CELLS), m["name"]
        assert callable(spec.reader(home, m["name"]))
    for c in BENCH["configs"]:
        assert any(w["config"] == c["name"] for w in BENCH["workloads"]), c["name"]


def test_a_split_metric_reads_as_its_original():
    home = ROOT / BENCH["paths"][0]
    run = SimpleNamespace(counters={"batcher": {"before": {"batches": 2, "requests": 5},
                                                "after": {"batches": 6, "requests": 17}},
                                    "graphs": {"before": 7, "after": 9}})
    for m in BENCH["per_layer"]:
        if m["name"].endswith(".p50") and m["name"][:-4] in ("serve.batch_mean",
                                                             "inference.captures"):
            assert spec.reader(home, m["name"])(run) == spec.reader(home, m["name"][:-4])(run)

