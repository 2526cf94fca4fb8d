"""Every entry of BENCHMARK.json resolves to its files by name, and the
file keeps to the limits the harness relies on."""
import json
import re

import pytest

from port_bench import cell as C

SPEC = C.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[k]}) == len(SPEC[k])
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in SPEC["end_to_end"]
               + SPEC["per_layer"])
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_command_stays_in_paths():
    cmd = SPEC["command"]
    assert cmd[:3] == ["python3", "-m", "port_bench.run"]
    assert SPEC["paths"] == ["port_bench"]


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith("port_bench/configs/")
    cfg = json.loads((C.ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["source"]
    assert cfg["reduced"] == c["reduced"] == []
    assert (C.HERE / cfg["reference"].split("port_bench/")[-1]).exists()
    assert set(cfg["precision"].values()) <= {"f32", "bf16"}


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_files(w):
    mix = json.loads((C.HERE / "traffic" / f"{w['traffic']}.json").read_text())
    assert hasattr(C.driver(mix["driver"]), "Driver")
    assert w["chips"] == 1 and len(w["why"]) <= 200
    limits = json.loads((C.HERE / "limits" / f"{w['name']}.json").read_text())
    assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers(m):
    assert callable(C.reader(m["name"]).read)


@pytest.mark.parametrize("path", sorted((C.HERE / "metrics").glob("[a-z]*.py")),
                         ids=lambda p: p.stem)
def test_every_reader_file_reads(path):
    """No reader file is left without a reader."""
    assert callable(C.reader(path.stem).read)


def test_per_layer_moves_reported_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        moves = e2e[m["moves"]]
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(moves.get("workloads", cells))
    for w in cells:
        cell_e2e = [x for x in SPEC["end_to_end"]
                    if w in x.get("workloads", cells)]
        assert {"setup_s"} < {x["name"] for x in cell_e2e}
        assert any(w in m["workloads"] for m in SPEC["per_layer"])


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
