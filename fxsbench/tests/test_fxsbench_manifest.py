"""BENCHMARK.json against the benchmark's contract, and a cell, a traffic
mix and a per-layer metric added as data only."""
import json
import re

from conftest import REPO, TINY

from fxsbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"_dim$|_rank$|expansion|experts_per_token|"
                   r"n_radial_points|max_order|n_theta|n_phi)")


def manifest():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_units_and_files():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "fxsbench/run.py"]
    assert m["paths"] == ["fxsbench"]
    assert 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("fxsbench/") and (REPO / c["file"]).is_file()
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in m["workloads"])
        names.append(c["name"])
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and line(w["why"])
        assert w["config"] in names
        assert (REPO / "fxsbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        names.append(w["name"])
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        names.append(e["name"])
    layers = {}
    for p in m["per_layer"]:
        assert set(p) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert p["moves"] in e2e and line(p["layer"])
        assert (REPO / "fxsbench/metrics" / f"{p['name']}.py").is_file()
        for cell in p["workloads"]:
            assert p in bench.cell_metrics(m, cell, "per_layer")
        layers.setdefault(p["layer"].lower(), set()).add(p["layer"])
        names.append(p["name"])
    assert all(len(v) == 1 for v in layers.values())
    for x in names + [w["traffic"] for w in m["workloads"]]:
        assert NAME.match(x), x
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in m["workloads"]:
        assert bench.cell_metrics(m, w["name"], "per_layer")
        assert len(bench.cell_metrics(m, w["name"], "end_to_end")) >= 2


def test_a_cell_a_mix_and_a_metric_added_as_data_only(tiny_root):
    """A traffic mix, a cell and a per-layer metric that exist only as new
    files and entries run, and the metric is reported."""
    (tiny_root / "fxsbench/traffic/batch3.json").write_text(json.dumps(
        {"batch_size": 3, "loop": "closed", "schedule": "settings",
         "why": "three restarts a batch"}))
    (tiny_root / "fxsbench/metrics/host_ops_per_batch.py").write_text(
        "def read(w):\n    return len(w.host_ops) / w.batches or None\n")
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "tiny.batch3", "config": "tiny",
                           "traffic": "batch3", "chips": 1, "why": "new"})
    m["per_layer"].append({"name": "host_ops_per_batch", "unit": "ops",
                           "better": "lower", "source": "device_trace",
                           "layer": "phasing dispatch",
                           "moves": "restarts_per_hour",
                           "workloads": ["tiny.batch3"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(m))
    r = bench.run("tiny.batch3", 11, 0.1, True, root=tiny_root, device="cpu")
    assert r["window"]["batch_size"] == 3 and r["attempted"] == 3
    assert r["metrics"]["host_ops_per_batch"]["value"] > 0
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    r = bench.run(TINY, 11, 0.1, False, root=tiny_root, device="cpu")
    assert set(r["metrics"]) == {"restarts_per_hour", "peak_mem_gib",
                                 "setup_s"}
