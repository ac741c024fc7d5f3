"""BENCHMARK.json against the contract's shape, and discovery by name:
every cell, configuration, traffic mix, limit file and per-layer reader
is a file found by its name, and a new one is added by adding files."""

import importlib.util
import json
import os
import re
import shutil

import pytest

from tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    assert len(json.dumps(b)) < 64 * 1024


def test_every_name_has_its_files():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            desc = json.load(f)
        assert desc["name"] == c["name"] and desc["reduced"] == c["reduced"]
        assert desc["channel_cfg"]
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        for part in (("workloads", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(ROOT, "perfbench", *part)
                                  + ".json")
    for m in b["per_layer"]:
        path = os.path.join(ROOT, "perfbench", "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)


def test_a_cell_config_and_metric_are_added_as_files(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell and a per-layer metric by new files and new entries alone; the
    harness of the copy finds each by name."""
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in
              (tmp_path / "perfbench").rglob("*") if p.is_file()}
    b = bench()
    desc = json.load(open(os.path.join(ROOT, b["configs"][0]["file"])))
    desc["name"] = "deeplabv3_r101_p50_copy"
    (tmp_path / "perfbench/configs/deeplabv3_r101_p50_copy.json").write_text(
        json.dumps(desc))
    traffic = json.load(open(os.path.join(
        ROOT, "perfbench/workloads/closed_b1_1025x2049.json")))
    traffic["frame_hw"] = [513, 1025]
    (tmp_path / "perfbench/workloads/closed_b1_513x1025.json").write_text(
        json.dumps(traffic))
    (tmp_path / "perfbench/limits/serve.copy.b1.json").write_text(
        json.dumps({"tail_off": 0.0}))
    (tmp_path / "perfbench/metrics/serve.k1_ms.py").write_text(
        "def read(w, ctx):\n    return w.per_unit_ms('k1')\n")
    b["configs"].append(dict(b["configs"][0], name=desc["name"],
                             file="perfbench/configs/"
                                  "deeplabv3_r101_p50_copy.json"))
    b["workloads"].append({"name": "serve.copy.b1", "config": desc["name"],
                           "traffic": "closed_b1_513x1025", "chips": 1,
                           "why": "a test"})
    b["per_layer"].append({"name": "serve.k1_ms", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "tail K1", "moves": "serve_img_per_s",
                           "workloads": ["serve.copy.b1"]})
    for m in b["end_to_end"]:
        if "workloads" in m and "serve.r101p50.b1" in m["workloads"]:
            m["workloads"].append("serve.copy.b1")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    spec = importlib.util.spec_from_file_location(
        "perfbench_copy_run", tmp_path / "perfbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    cell = run.cell_spec(run.load_json("BENCHMARK.json"), "serve.copy.b1")
    assert cell["desc"]["name"] == "deeplabv3_r101_p50_copy"
    assert cell["traffic"]["frame_hw"] == [513, 1025]
    assert cell["limits"] == {"tail_off": 0.0}
    assert [m["name"] for m in cell["per_layer"]] == ["serve.k1_ms"]
    assert {m["name"] for m in cell["end_to_end"]} == {
        "serve_img_per_s", "serve_p95_ms", "setup_s"}

    class W:
        units = 2
        classes = {"k1": 0.001}

        def per_unit_ms(self, *c):
            return sum(self.classes[k] for k in c) / self.units * 1e3
    assert run.reader("serve.k1_ms")(W(), {}) == pytest.approx(0.5)
    after = {p: open(p, "rb").read() for p in before}
    assert after == before  # nothing that was there changed


def test_readers_return_nothing_without_their_kernels():
    from perfbench import run
    from perfbench.trace import Window
    empty = Window(units=3, window_s=1.0, busy_s=0.5, kernels={},
                   classes={}, device_ops=[], idle_gaps=[])
    for name in ("serve.k1_roofline", "serve.conv_ms", "train.bn_ms",
                 "train.optim_ms", "serve.copy_ms"):
        assert run.reader(name)(empty, {"k1_bound_s": 1e-6}) is None
