"""BENCHMARK.json against the benchmark's contract, and every file a cell
is found by; a static scan of the benchmark's imports."""

import ast
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in MANIFEST["end_to_end"]}
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}


def reports(cell: str, metric: dict) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_text(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(set(names)) == len(names)
    for e in MANIFEST[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]


def test_every_config_has_a_cell_and_its_files():
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        family = json.loads((ROOT / c["file"]).read_text())["family"]
        assert (HERE / "adapters" / f"{family}.py").is_file()
    for w in MANIFEST["workloads"]:
        assert w["chips"] == 1
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((HERE / "limits" / f"{w['name']}.json")
                            .read_text())
        assert limits["limits"]["off_kernel"] == 0


def test_every_cell_reports_setup_an_e2e_and_a_layer_metric():
    for cell in CELLS:
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if reports(cell, m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        traffic = json.loads((HERE / "traffic"
                              / f"{CELLS[cell]['traffic']}.json").read_text())
        for name in e2e:
            if name != "setup_s":
                assert traffic["metrics"][name] in ("rate", "call_p95_ms")
        assert any(reports(cell, m) for m in MANIFEST["per_layer"])


def test_per_layer_moves_what_its_cells_report():
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in E2E and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert cell in CELLS
            assert reports(cell, E2E[m["moves"]])
        family = m["name"].split(".")[0]
        assert (HERE / "metrics" / f"{family}.py").is_file()
        layers.setdefault(family, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value)
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    assert "benchmarks" not in tops
    if path.parent.name == "reference":
        assert "repro_torch" not in tops
