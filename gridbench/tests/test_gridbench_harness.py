"""The harness on the CPU: every piece found by name, BENCHMARK.json within
its rules, no forbidden import, readable kernel names and the last line's
schema."""

import ast
import json
import re
from pathlib import Path

import pytest

from gridbench.harness import env, loop, runner, spec, trace
from gridbench.tests.conftest import small

BENCH = spec.load_benchmark()
GRIDBENCH = spec.BENCH_DIR
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
E2E = {m["name"] for m in BENCH["end_to_end"]}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gridbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    assert (spec.ROOT / BENCH["command"][1]).is_file()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert spec.NAME_RE.match(k)
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        for k in ("name", "config", "traffic"):
            assert spec.NAME_RE.match(w[k]), w[k]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in E2E and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.NAME_RE.match(m["name"]) and spec.UNIT_RE.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in CELLS
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for group in (names, CELLS, METRICS):
        assert len(group) == len(set(group))
        for n in group:
            assert spec.NAME_RE.match(n)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


def test_every_cell_reports_setup_and_its_metrics():
    for w in CELLS:
        e2e = [m["name"] for m in spec.metrics_of(BENCH, w, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(BENCH, w, True)
        for m in spec.metrics_of(BENCH, w, True):
            assert m["moves"] in e2e, (w, m["name"])
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("w", CELLS)
def test_cell_pieces_found_by_name(w):
    cell = spec.cell(BENCH, w)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    assert cfg["name"] == cell["config"] and cfg["chips"] == cell["chips"]
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert conf["file"] == f"gridbench/configs/{cell['config']}.json"
    assert conf["source"] == cfg["source"] and len(cfg["source"]) <= 200
    assert sorted(conf["reduced"]) == sorted(cfg["reduced"])
    assert cfg["engine"] in ("CudaConfig", "PodConfig")
    assert cfg["engine_settings"]["ingest"] != "auto"  # the route is pinned
    assert hasattr(spec.driver(mix["driver"]), "Driver")


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_by_name(metric):
    assert callable(spec.reader(metric))
    assert spec.reader(metric)({}) is None  # nothing to read: nothing returned


def test_every_config_file_is_used():
    used = {c["file"] for c in BENCH["configs"]}
    assert used == {f"gridbench/configs/{w['config']}.json"
                    for w in BENCH["workloads"]}


def test_reduced_matches_the_config_file():
    """Each cut the configuration file gives a reason for is listed in
    BENCHMARK.json, and nothing more."""
    for c in BENCH["configs"]:
        assert sorted(spec.config(c["name"])["reduced"]) == sorted(c["reduced"])


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


SOURCES = sorted(p for p in GRIDBENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(GRIDBENCH)))
def test_no_forbidden_import(path):
    for name in _imports(path):
        assert name.split(".", 1)[0] not in env.FORBIDDEN, (path, name)
    text = path.read_text()
    for other in ("benchmarks/", "bench.py", "chip_smoke"):
        assert other not in text


@pytest.mark.parametrize("path", sorted((GRIDBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        assert name.split(".", 1)[0] not in ("redisson_tpu_torch",) + env.FORBIDDEN


def test_forbidden_names_compared_whole(monkeypatch):
    import sys
    import types

    import redisson_tpu_torch  # noqa: F401 - begins with the JAX package's name

    assert env.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "redisson_tpu.config", types.ModuleType("x"))
    assert env.forbidden_loaded() == ["redisson_tpu"]


@pytest.mark.parametrize("raw,short", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor"
     "<long, long, long, at::native::BitwiseXorFunctor<long> >, std::array<char*, "
     "3ul> >(int, at::native::BinaryFunctor<long, long, long, "
     "at::native::BitwiseXorFunctor<long> >, std::array<char*, 3ul>)",
     "vectorized_elementwise_kernel[BitwiseXorFunctor]"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor"
     "<unsigned char>, std::array<char*, 1ul> >(int, at::native::FillFunctor"
     "<unsigned char>, std::array<char*, 1ul>)",
     "vectorized_elementwise_kernel[FillFunctor]"),
    ("void (anonymous namespace)::bitop_vec_kernel<1>(uint4 const*, uint4*, int, "
     "long long)", "bitop_vec_kernel[1]"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
])
def test_kernel_names_readable(raw, short):
    got = trace.short_name(raw)
    assert len(got) <= 64 and got == short


def test_p95_nearest_rank():
    assert loop.p95([]) is None
    assert loop.p95(list(range(1, 101))) == 95
    assert loop.p95([3.0]) == 3.0


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_schema(traced, capsys):
    import time

    cfg, mix = small("bitset_dau", "monthly_rollup")
    line, checks = runner.run_cell(BENCH, "bitset_dau.monthly_rollup", 2**31 + 11,
                                   0.3, traced, time.time(), ["cpu"], "", cfg, mix)
    runner.emit(line, checks)
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert list(last)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] > 0
    for name, m in last["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(last["device"])
    wanted = {m["name"] for m in spec.metrics_of(BENCH, "bitset_dau.monthly_rollup", traced)}
    if traced:
        assert {"busy_s", "window_s"} <= set(last["device"])
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
        # no card, no device time: the roofline has nothing to read
        assert set(last["metrics"]) <= wanted
    else:
        assert set(last["metrics"]) == wanted
    tail = out.err.strip().splitlines()[-len(checks):]
    assert all(re.match(r"check \S+: \S+ \(limit \S+\)$", t) for t in tail)
    assert env.forbidden_loaded() == []
