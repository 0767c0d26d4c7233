"""The benchmark's files are found by name, and BENCHMARK.json keeps to
the contract's shape."""

import importlib
import math
import re

from cmhbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_configuration_traffic_and_limits():
    bench = spec.load()
    for cell in bench["workloads"]:
        cfg = spec.config(bench, cell["config"])
        traffic = spec.traffic(cell["traffic"])
        limits = spec.limits(cell["name"])
        assert cfg["name"] == cell["config"]
        kind = importlib.import_module(f"cmhbench.kinds.{traffic['kind']}")
        assert callable(kind.run)
        assert limits and all(v >= 0 for v in limits.values())


def test_every_configuration_finds_its_method_and_reference():
    bench = spec.load()
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        glue, ref = spec.method(cfg), spec.reference(cfg)
        assert glue.ARCH and glue.RUNNER and glue.head_leaves(cfg) and glue.head_flops(cfg) > 0
        assert all(callable(getattr(ref, f)) for f in ("image_codes", "text_codes", "bits",
                                                        "train_steps"))


def test_a_method_added_as_files_is_picked_up(tmp_path, monkeypatch):
    import cmhbench.methods
    import cmhbench.reference

    for pkg in (cmhbench.methods, cmhbench.reference):
        folder = tmp_path / pkg.__name__.split(".")[1]
        folder.mkdir()
        (folder / "newhash.py").write_text(f"WHERE = {pkg.__name__!r}\n")
        monkeypatch.setattr(pkg, "__path__", list(pkg.__path__) + [str(folder)])
    assert spec.method({"method": "NewHash"}).WHERE == "cmhbench.methods"
    assert spec.reference({"method": "NewHash"}).WHERE == "cmhbench.reference"


def test_every_per_layer_metric_has_a_reader():
    bench = spec.load()
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_a_metric_added_as_a_file_is_picked_up(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "late_start_ms.newcell.py").write_text(
        "def read(outcome):\n    return outcome['x'] * 2\n")
    monkeypatch.setattr(spec, "PKG", tmp_path)
    assert spec.reader("late_start_ms.newcell")({"x": 21}) == 42


def test_a_cell_reports_the_metrics_that_list_it():
    bench = spec.load()
    names = {m["name"] for m in spec.metrics(bench, "dcmht-vitb32-valid", "end_to_end")}
    assert names == {"valid_s", "setup_s"}
    names = {m["name"] for m in spec.metrics(bench, "dcmht-vitl14-train", "per_layer")}
    assert {"train_mfu", "k2_roofline.train", "device_idle.train"} <= names
    assert not any(n.endswith(".search") or n.endswith(".valid") for n in names)


def test_benchmark_keeps_to_the_contract():
    bench = spec.load()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["cmhbench"] and 1 <= bench["run_seconds"] <= 51
    cells = 24
    assert (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cmhbench/") and c["reduced"] == []
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for cell in bench["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] == 1 and len(cell["why"]) <= 200
        reports = {m["name"] for m in spec.metrics(bench, cell["name"], "end_to_end")}
        assert "setup_s" in reports and len(reports) >= 2
        layers = spec.metrics(bench, cell["name"], "per_layer")
        assert layers and all(m["moves"] in reports for m in layers)
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert not math.isnan(bench["run_seconds"])
