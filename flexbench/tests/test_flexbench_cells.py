"""BENCHMARK.json well formed, and every cell found by name."""
import json
import re
import subprocess
import sys

import pytest

from flexbench import cells, run

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["flexbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "flexbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a check of 24 cells at this run length fits in 12 hours
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_are_well_formed():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    perf = (cells.ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        # the layer as PERF.md's list of layers names it, letter for letter
        assert f"| {m['layer']} |" in perf, m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for name in CELLS:
        cell = cells.resolve(name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files_by_name(name):
    cell = cells.resolve(name)
    w = {x["name"]: x for x in BENCH["workloads"]}[name]
    conf = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert cell.config["name"] == conf["name"]
    assert set(conf["reduced"]) <= set(cell.config)
    assert cell.config["reduced"] == conf["reduced"]
    assert cell.mix["kind"] == "block_read"
    assert cell.driver_path.name == f"{cell.config['driver']}.py"
    assert cell.driver_path.exists()
    assert cell.chips == 1
    for m, reader in cell.per_layer:
        assert reader.name == f"{m['name']}.py"
        mod = cells.load_module(reader, "t_" + m["name"].replace(".", "_"))
        assert callable(mod.read)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.resolve("no.such.cell")


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert run.forbidden_modules() == []
    for bad in ("repro", "jax", "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, f"{bad}.sub", sys)
    assert run.forbidden_modules() == ["flax", "jax", "jaxlib", "repro"]


def test_what_a_run_imports_holds_no_jax_and_no_reference_package():
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "from flexbench import run, cells, control, devtrace, traffic\n"
            "from flexbench.drivers import solar\n"
            "from flexbench.reference import solar as rs\n"
            "import repro_torch.core.solar\n"
            "for n in ('flexbench/layer_metrics',):\n"
            "    import pathlib\n"
            "    for p in sorted(pathlib.Path(n).glob('*.py')):\n"
            "        cells.load_module(p, 'm_' + p.stem.replace('.', '_'))\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for p in (cells.HERE / "reference").glob("*.py"):
        text = p.read_text()
        assert "repro" not in re.sub(r"#.*", "", text).replace(
            "flexbench", ""), p
