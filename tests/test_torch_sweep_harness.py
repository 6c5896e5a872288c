"""The port's sweep harness (repro_torch.sweep): planning, resume,
dry-run, analysis, and its parity with the JAX reference's repro.sweep.

The first four classes mirror tests/test_sweep.py case for case against
the port (the resumability/byte-identity contract: an interrupted and
resumed sweep, a process-parallel sweep and a serial uninterrupted
sweep finalize to byte-identical ``points.jsonl``; ``--dry-run`` rejects
sub-Vt supplies and cutoff-infeasible CIM points with recorded reasons;
logs and reports reject version/config-hash mismatches).

Parity with the reference, on the CPU:
  * every committed config in configs/sweeps/: the same config_hash,
    point IDs and order, and dry-run feasibility and reasons point by
    point;
  * grid-echo: the finalized ``points.jsonl`` and the rendered summary
    byte-identical;
  * cim-accuracy at the noiseless paper point on the committed
    checkpoint (64 images): the record equal to the reference measure's;
  * ci_smoke.json end to end: tops_per_w, cost_unit, grid and the
    frontier flags equal. Its scores come from noisy calibration (two
    noise draws a layer, torch generators against jax keys), held as
    tests/test_torch_sweep.py holds noisy sweeps: within
    5 * sqrt(2 / 2) * max(sd, 0.02 * score) + 1e-6 of the reference's,
    sd the per-draw spread of the port's own single-draw sweeps (the
    accuracy stub is 1 - 2 * score: twice that).

Every test runs with ``REPRO_TORCH_AUTOTUNE_DIR`` in a temporary
directory, so none reads or writes the repository's tuning caches.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.sweep import measures as jmeasures
from repro.sweep import runner as jrunner
from repro.sweep.config import SweepConfig as JSweepConfig
from repro.sweep.config import load_config as jload_config
from repro_torch.sweep import analysis, measures, plan, report, runner
from repro_torch.sweep.config import (
    REPO_ROOT,
    SWEEP_VERSION,
    SweepConfig,
    load_config,
)

CONFIGS = REPO_ROOT / "configs" / "sweeps"
COMMITTED = sorted(p.name for p in CONFIGS.glob("*.json"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tuning_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DIR", str(tmp_path / "tune"))


def echo_config(tmp_path, **over) -> SweepConfig:
    d = {
        "name": "echo",
        "measure": "grid-echo",
        "axes": {"adc_bits": [3, 4], "vdd": [0.6, 0.9]},
        "analysis": "table",
        "out_dir": str(tmp_path / "out"),
    }
    d.update(over)
    return SweepConfig.from_dict(d)


class TestConfigAndPlan:
    def test_hash_excludes_out_dir(self, tmp_path):
        a = echo_config(tmp_path / "a")
        b = echo_config(tmp_path / "b")
        assert a.config_hash == b.config_hash
        assert a.sweep_dir != b.sweep_dir

    def test_hash_changes_with_axes_and_params(self, tmp_path):
        a = echo_config(tmp_path)
        b = echo_config(tmp_path, axes={"adc_bits": [3], "vdd": [0.6]})
        c = a.override(params={"k": 1})
        assert len({a.config_hash, b.config_hash, c.config_hash}) == 3

    def test_expand_is_ordered_and_stable(self, tmp_path):
        cfg = echo_config(tmp_path)
        pts = plan.expand(cfg)
        assert [p.index for p in pts] == [0, 1, 2, 3]
        # sorted axis names, values in config order
        assert [p.values for p in pts] == [
            {"adc_bits": 3, "vdd": 0.6},
            {"adc_bits": 3, "vdd": 0.9},
            {"adc_bits": 4, "vdd": 0.6},
            {"adc_bits": 4, "vdd": 0.9},
        ]
        assert [p.point_id for p in pts] == [
            p.point_id for p in plan.expand(echo_config(tmp_path / "x"))
        ]
        assert len({p.point_id for p in pts}) == 4

    def test_bad_configs_raise(self):
        with pytest.raises(ValueError, match="non-empty 'name'"):
            SweepConfig.from_dict({"name": "", "measure": "m",
                                   "axes": {"a": [1]}})
        with pytest.raises(ValueError, match="axes"):
            SweepConfig.from_dict({"name": "x", "measure": "m",
                                   "axes": {}})
        with pytest.raises(ValueError, match="axis 'a'"):
            SweepConfig.from_dict({"name": "x", "measure": "m",
                                   "axes": {"a": []}})
        with pytest.raises(ValueError, match="unknown sweep config field"):
            SweepConfig.from_dict({"name": "x", "measure": "m",
                                   "axes": {"a": [1]}, "bogus": 1})

    def test_load_config_json_and_py(self, tmp_path):
        j = tmp_path / "c.json"
        j.write_text(json.dumps({"name": "j", "measure": "grid-echo",
                                 "axes": {"a": [1, 2]}}))
        assert load_config(j).name == "j"
        p = tmp_path / "c.py"
        p.write_text(
            "CONFIG = {'name': 'p', 'measure': 'grid-echo',\n"
            "          'axes': {'a': list(range(3))}}\n"
        )
        cfg = load_config(p)
        assert cfg.axes["a"] == (0, 1, 2)
        with pytest.raises(FileNotFoundError):
            load_config(tmp_path / "missing.json")

    def test_unknown_measure_rejected(self, tmp_path):
        cfg = echo_config(tmp_path, measure="no-such-measure")
        with pytest.raises(ValueError, match="unknown measure"):
            runner.dry_run(cfg)

    def test_module_attr_measure_resolves(self):
        m = measures.resolve("repro_torch.sweep.measures:_grid_echo")
        assert m.fn is measures._grid_echo


class TestDryRun:
    def test_rejects_sub_vt_vdd_and_infeasible_cutoff(self, tmp_path):
        cfg = echo_config(
            tmp_path,
            axes={"rows_active": [16], "adc_bits": [4],
                  "cutoff": [0.5, 0.9], "vdd": [0.3, 0.6]},
        )
        recs = runner.dry_run(cfg)
        by_point = {
            (r["point"]["cutoff"], r["point"]["vdd"]): r for r in recs
        }
        assert by_point[(0.5, 0.6)]["feasible"]
        sub_vt = by_point[(0.5, 0.3)]
        assert not sub_vt["feasible"] and "Vt" in sub_vt["reason"]
        bad_cut = by_point[(0.9, 0.6)]
        assert not bad_cut["feasible"]
        assert "pMAC spacing" in bad_cut["reason"]

    def test_rejects_unknown_variant(self, tmp_path):
        cfg = echo_config(tmp_path, axes={"variant": ["p8t", "bogus"]})
        recs = runner.dry_run(cfg)
        assert recs[0]["feasible"]
        assert not recs[1]["feasible"]
        assert "unknown variant" in recs[1]["reason"]

    def test_shape_axis_names_vs_tuning_cells(self, tmp_path):
        """A string "shape" is a launch-cell name (registry-checked);
        a [m, k, n] list is a kernel tuning cell and passes through to
        the measure's own validation."""
        named = echo_config(
            tmp_path, axes={"arch": ["whisper_tiny"],
                            "shape": ["decode_32k", "bogus_shape"]}
        )
        recs = runner.dry_run(named)
        assert recs[0]["feasible"]  # values keep config order
        assert not recs[1]["feasible"]
        assert "unknown shape" in recs[1]["reason"]
        cells = echo_config(
            tmp_path, name="cells",
            axes={"variant": ["p8t"], "shape": [[8, 512, 512]]},
        )
        assert all(r["feasible"] for r in runner.dry_run(cells))

    def test_dry_run_executes_nothing(self, tmp_path):
        cfg = echo_config(tmp_path)
        runner.dry_run(cfg)
        assert not cfg.points_path.exists()


class TestRunnerResume:
    def test_infeasible_points_recorded_as_skips(self, tmp_path):
        cfg = echo_config(
            tmp_path, axes={"adc_bits": [4], "vdd": [0.3, 0.6]},
        )
        rep = runner.run(cfg, log=lambda _s: None)
        assert (rep.n_ok, rep.n_skipped) == (1, 1)
        recs = sorted(runner.read_points(cfg).values(),
                      key=lambda r: r["index"])
        assert recs[0]["status"] == "skipped"
        assert "Vt" in recs[0]["reason"]
        assert recs[1]["status"] == "ok"

    def test_interrupted_resume_is_byte_identical(self, tmp_path):
        straight = echo_config(tmp_path / "a")
        rep = runner.run(straight, log=lambda _s: None)
        assert rep.finalized and rep.n_ok == 4

        # "Kill" after 2 points, then restart: the resumed run must
        # skip the completed points and finalize identical bytes.
        resumed = echo_config(tmp_path / "b")
        rep1 = runner.run(resumed, max_points=2, log=lambda _s: None)
        assert not rep1.finalized and rep1.n_ok == 2
        rep2 = runner.run(resumed, log=lambda _s: None)
        assert rep2.finalized
        assert rep2.n_prior == 2 and rep2.n_ok == 2
        assert (resumed.points_path.read_bytes()
                == straight.points_path.read_bytes())

    def test_torn_trailing_line_is_dropped_and_rerun(self, tmp_path):
        cfg = echo_config(tmp_path)
        runner.run(cfg, max_points=2, log=lambda _s: None)
        with cfg.points_path.open("a") as f:
            f.write('{"version": 1, "config_hash": "trunc')  # torn
        rep = runner.run(cfg, log=lambda _s: None)
        assert rep.finalized and rep.n_prior == 2
        clean = echo_config(tmp_path / "clean")
        runner.run(clean, log=lambda _s: None)
        assert (cfg.points_path.read_bytes()
                == clean.points_path.read_bytes())

    def test_corrupt_mid_log_raises(self, tmp_path):
        cfg = echo_config(tmp_path)
        runner.run(cfg, max_points=2, log=lambda _s: None)
        lines = cfg.points_path.read_text().splitlines()
        lines[0] = "not json"
        cfg.points_path.write_text("\n".join(lines) + "\n")
        with pytest.raises(ValueError, match="corrupt record"):
            runner.read_points(cfg)

    def test_mismatched_config_hash_rejected(self, tmp_path):
        cfg = echo_config(tmp_path)
        runner.run(cfg, log=lambda _s: None)
        changed = echo_config(tmp_path, params={"new": 1})
        with pytest.raises(ValueError, match="config_hash"):
            runner.run(changed, log=lambda _s: None)

    def test_mismatched_version_rejected(self, tmp_path):
        cfg = echo_config(tmp_path)
        runner.run(cfg, log=lambda _s: None)
        recs = [json.loads(line) for line in
                cfg.points_path.read_text().splitlines()]
        recs[0]["version"] = SWEEP_VERSION + 1
        cfg.points_path.write_text(
            "".join(runner.record_line(r) + "\n" for r in recs)
        )
        with pytest.raises(ValueError, match="version"):
            runner.read_points(cfg)

    def test_parallel_run_matches_serial_bytes(self, tmp_path):
        serial = echo_config(tmp_path / "s")
        runner.run(serial, log=lambda _s: None)
        par = echo_config(tmp_path / "p")
        rep = runner.run(par, jobs=2, log=lambda _s: None)
        assert rep.finalized
        assert (par.points_path.read_bytes()
                == serial.points_path.read_bytes())


class TestAnalysis:
    def test_table_renderer_is_deterministic(self, tmp_path):
        cfg = echo_config(tmp_path)
        runner.run(cfg, log=lambda _s: None)
        first = [p.read_bytes() for p in analysis.analyze(cfg)]
        second = [p.read_bytes() for p in analysis.analyze(cfg)]
        assert first == second
        summary = json.loads(first[0])
        assert summary["config_hash"] == cfg.config_hash
        assert summary["n_points"] == 4

    def test_analyze_without_run_raises(self, tmp_path):
        cfg = echo_config(tmp_path)
        with pytest.raises(ValueError, match="no points recorded"):
            analysis.analyze(cfg)

    def test_unknown_renderer_raises(self, tmp_path):
        cfg = echo_config(tmp_path, analysis="bogus")
        runner.run(cfg, log=lambda _s: None)
        with pytest.raises(ValueError, match="unknown analysis"):
            analysis.analyze(cfg)

    def test_load_report_rejects_version_mismatch(self, tmp_path):
        payload = report.pareto_payload(
            "m", [], cost_unit="fJ/MAC", slack=2.0, grid=None,
        )
        jpath, _ = report.write_payload(payload, tmp_path)
        assert report.load_report(jpath)["model"] == "m"
        stale = dict(payload, version=1)
        jpath.write_text(json.dumps(stale))
        with pytest.raises(ValueError, match="report version"):
            report.load_report(jpath)

    def test_autotune_renderer_roundtrips_cache(self, tmp_path):
        from repro_torch.kernels import autotune

        cfg = echo_config(
            tmp_path, name="tune", measure="grid-echo",
            analysis="autotune", params={"arch": "testarch"},
            axes={"variant": ["p8t"], "shape": [[8, 512, 512]]},
        )
        # Hand-write ok records in the autotune result shape (the real
        # measure times kernels; rendering is what's under test).
        pts = plan.expand(cfg)
        recs = [
            runner._make_record(
                cfg, p, status="ok",
                result={
                    "variant": p.values["variant"],
                    "shape": list(p.values["shape"]),
                    "cell": [8, 512, 512],
                    "backend": "ref", "block": None, "us": 12.5,
                },
            )
            for p in pts
        ]
        cfg.sweep_dir.mkdir(parents=True)
        cfg.points_path.write_text(
            "".join(runner.record_line(r) + "\n" for r in recs)
        )
        (path,) = analysis.analyze(cfg)
        payload = json.loads(path.read_text())
        assert payload["config_hash"] == cfg.config_hash
        cache = autotune.TuningCache.from_json(payload)
        w = cache.lookup("p8t", (8, 512, 512))
        assert w is not None and w.backend == "ref"


class TestParetoMeasureSmoke:
    def test_ci_smoke_config_end_to_end(self, tmp_path):
        cfg = load_config(
            pathlib.Path(__file__).resolve().parents[1]
            / "configs" / "sweeps" / "ci_smoke.json"
        ).override(out_dir=str(tmp_path), params={"device": "cpu"})
        recs = runner.dry_run(cfg)
        assert all(r["feasible"] for r in recs)
        rep = runner.run(cfg, log=lambda _s: None)
        assert rep.finalized and rep.n_ok == 2
        jpath, mpath = analysis.analyze(cfg)
        payload = report.load_report(jpath)
        assert payload["cost_unit"] == "fJ/MAC"
        assert len(payload["points"]) == 2
        assert any(p["frontier"] for p in payload["points"])
        assert payload["config_hash"] == cfg.config_hash


# ---------------------------------------------------------------------------
# The port's own contracts
# ---------------------------------------------------------------------------


class TestPortContracts:
    def test_default_out_dir_is_build_not_results(self):
        cfg = load_config(CONFIGS / "accuracy_study.json")
        assert cfg.sweep_dir == REPO_ROOT / "build" / "sweeps" / \
            "accuracy_study"
        assert cfg.override(out_dir="x/y").sweep_dir == REPO_ROOT / "x/y"

    def test_dryrun_cell_is_registered(self):
        assert "dryrun-cell" in measures.registered()
        m = measures.resolve("dryrun-cell")
        assert m.name == "dryrun-cell" and m.validate is not None

    def test_asking_for_the_card_without_one_fails(self, tmp_path,
                                                   monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = load_config(CONFIGS / "ci_smoke.json").override(
            out_dir=str(tmp_path))
        with pytest.raises(RuntimeError, match="is_available"):
            runner.run(cfg, log=lambda _s: None)
        assert runner.read_points(cfg) == {}

    def test_missing_checkpoint_is_trained_and_saved(self, tmp_path,
                                                     monkeypatch):
        """No checkpoint: cim-accuracy trains the baseline, as the
        reference's measure does, and saves it under the build directory
        (never under results/)."""
        import functools

        from repro_torch.checkpoint import store
        from repro_torch.configs import resnet as rcfg

        monkeypatch.setattr(rcfg, "CHECKPOINT_DIR", tmp_path / "none")
        monkeypatch.setattr(rcfg, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(measures, "_RESNET_BASELINE", {})
        monkeypatch.setattr(rcfg, "train_resnet_baseline", functools.partial(
            rcfg.train_resnet_baseline, steps=2, batch=4))
        monkeypatch.setattr(measures, "evaluate", functools.partial(
            measures.evaluate, batch=4))
        cfg = echo_config(tmp_path, name="acc", measure="cim-accuracy",
                          params={"device": "cpu", "n_images": 4},
                          axes={"rows_active": [16], "noisy": [False]})
        rep = runner.run(cfg, log=lambda _s: None)
        assert rep.n_ok == 1
        assert store.latest_step(tmp_path / "build") == 2
        assert not (tmp_path / "none").exists()
        params, bn = measures._RESNET_BASELINE["cpu"]
        saved = rcfg.load_baseline(tmp_path / "build", device="cpu")
        for name, t in store.leaves_with_names({"params": params,
                                                "bn": bn}):
            *path, leaf = name.split("/")
            node = {"params": saved[0], "bn": saved[1]}
            for k in path:
                node = node[k]
            assert torch.equal(node[leaf], t), name

    def test_autotune_skips_only_an_empty_sweep(self, tmp_path,
                                                monkeypatch):
        """No feasible candidate is a recorded skip; a kernel failure
        (any other error) aborts the run."""
        from repro_torch.kernels import autotune

        cfg = echo_config(
            tmp_path, name="tune", measure="autotune",
            analysis="autotune", params={"device": "cpu"},
            axes={"variant": ["p8t"], "shape": [[8, 64, 64]]},
        )

        def empty(*a, **k):
            raise autotune.NoFeasibleCandidate("no feasible candidate")

        monkeypatch.setattr(autotune, "sweep_shape", empty)
        rep = runner.run(cfg, log=lambda _s: None)
        assert (rep.n_ok, rep.n_skipped) == (0, 1)

        def launch_failed(*a, **k):
            raise RuntimeError("gpq_matmul: launch failed")

        monkeypatch.setattr(autotune, "sweep_shape", launch_failed)
        fresh = cfg.override(out_dir=str(tmp_path / "fresh"))
        with pytest.raises(RuntimeError, match="launch failed"):
            runner.run(fresh, log=lambda _s: None)

    def test_autotune_measure_renders_a_cache_dispatch_reads(
            self, tmp_path):
        """The autotune measure on the CPU (one shape, the scan against
        the vectorized "ref", fake times), rendered with an earlier cache
        in the active directory: its cells are kept and named stale, and
        the rendered cache pins the measured winner for dispatch."""
        from repro_torch.core.pipeline import MacroSpec
        from repro_torch.kernels import autotune, dispatch

        prev = autotune.TuningCache(arch="cpu", sweep_version=1)
        prev.put("adder-tree", (64, 1024, 1024),
                 autotune.Winner("scan", None, 9.0, swept_at=1))
        prev.save()
        cfg = echo_config(
            tmp_path, name="tune", measure="autotune",
            analysis="autotune", params={"device": "cpu", "reps": 1},
            axes={"variant": ["p8t"], "shape": [[3, 40, 24]]},
        )
        times = {"scan": 2.0, "ref": 1.0}

        def measure(cand, run):
            run()
            return times[cand[0]]

        sweep_shape = autotune.sweep_shape

        def fake_clock(*a, **k):
            k["candidates"] = (("scan", None), ("ref", None))
            return sweep_shape(*a, measure=measure, **k)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(autotune, "sweep_shape", fake_clock)
            rep = runner.run(cfg, log=lambda _s: None)
        assert rep.finalized and rep.n_ok == 1
        (rec,) = runner.read_points(cfg).values()
        assert rec["result"]["backend"] == "ref"
        (path,) = analysis.analyze(cfg)
        payload = json.loads(path.read_text())
        assert payload["stale"] == [
            autotune.cell_id("adder-tree", (64, 1024, 1024))]
        cache = autotune.TuningCache.from_json(payload)
        assert cache.lookup("adder-tree", (64, 1024, 1024)).backend == "scan"
        autotune.set_active(cache)
        try:
            x = torch.randint(0, 16, (3, 40), dtype=torch.int32)
            w = torch.randint(-128, 128, (40, 24), dtype=torch.int8)
            with dispatch.record_resolutions() as log:
                dispatch.dispatch(x, w, MacroSpec())
            assert [(r.key.backend, r.source) for r in log] == \
                [("ref", "tuned")]
        finally:
            autotune.clear_active()

    def test_cli_imports_neither_jax_nor_the_reference(self, tmp_path):
        """A fresh interpreter runs --list-measures and two dry runs (one
        through the variant and dispatch registries), imports every
        package of the port, and has loaded neither jax nor repro, nor
        built or loaded a kernel library."""
        script = f"""
import runpy, sys
for argv in (["--list-measures"],
             [{str(CONFIGS / "accuracy_study.json")!r}, "--dry-run"],
             [{str(CONFIGS / "autotune_cpu.json")!r}, "--dry-run"]):
    sys.argv = ["repro_torch.sweep", *argv]
    try:
        runpy.run_module("repro_torch.sweep", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        assert e.code in (0, None), e.code
import repro_torch.checkpoint, repro_torch.configs, repro_torch.core
import repro_torch.kernels, repro_torch.models, repro_torch.serve
import repro_torch.distributed, repro_torch.launch.dryrun
from repro_torch.kernels import build
assert not build._LIBS and not build.BUILD_LOG
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("clean")
"""
        r = subprocess.run(
            [sys.executable, "-c", script], capture_output=True, text=True,
            timeout=120, cwd=tmp_path,
            env={**os.environ,
                 "PYTHONPATH": str(REPO_ROOT / "src")},
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert r.stdout.splitlines()[-1] == "clean"
        assert ("autotune\ncim-accuracy\ndryrun-cell\ngrid-echo\npareto\n"
                in r.stdout)
        assert "9 grid points, 9 feasible" in r.stdout
        assert "54 grid points, 54 feasible" in r.stdout


# ---------------------------------------------------------------------------
# Parity with the JAX reference's harness
# ---------------------------------------------------------------------------


def _pair(name: str, tmp_path):
    ref = jload_config(CONFIGS / name).override(out_dir=str(tmp_path / "j"))
    port = load_config(CONFIGS / name).override(out_dir=str(tmp_path / "t"))
    return ref, port


@pytest.mark.parametrize("name", COMMITTED)
def test_committed_config_plans_as_the_reference(name, tmp_path):
    ref, port = _pair(name, tmp_path)
    assert port.config_hash == ref.config_hash
    assert port.canonical() == ref.canonical()
    from repro.sweep import plan as jplan

    assert [(p.index, p.point_id, p.values) for p in plan.expand(port)] == \
        [(p.index, p.point_id, p.values) for p in jplan.expand(ref)]
    assert runner.dry_run(port) == jrunner.dry_run(ref)


def test_infeasible_corners_give_the_reference_reasons(tmp_path):
    axes = {"rows_active": [4, 16], "adc_bits": [4, 9], "cutoff": [0.5, 0.9],
            "vdd": [0.3, 0.6], "variant": ["p8t", "bogus"]}
    d = {"name": "corners", "measure": "grid-echo", "axes": axes}
    ref = JSweepConfig.from_dict({**d, "out_dir": str(tmp_path / "j")})
    port = SweepConfig.from_dict({**d, "out_dir": str(tmp_path / "t")})
    got, want = runner.dry_run(port), jrunner.dry_run(ref)
    assert got == want
    assert sum(r["feasible"] for r in got) < len(got)


def test_grid_echo_log_and_summary_byte_identical(tmp_path):
    d = {"name": "echo", "measure": "grid-echo", "analysis": "table",
         "axes": {"adc_bits": [3, 4, 5], "vdd": [0.3, 0.6, 0.9]}}
    ref = JSweepConfig.from_dict({**d, "out_dir": str(tmp_path / "j")})
    port = SweepConfig.from_dict({**d, "out_dir": str(tmp_path / "t")})
    jrunner.run(ref, log=lambda _s: None)
    runner.run(port, max_points=3, log=lambda _s: None)
    runner.run(port, log=lambda _s: None)
    assert port.points_path.read_bytes() == ref.points_path.read_bytes()
    from repro.sweep import analysis as janalysis

    got = [p.read_bytes() for p in analysis.analyze(port)]
    want = [p.read_bytes() for p in janalysis.analyze(ref)]
    assert got == want


def test_cim_accuracy_matches_reference_at_the_paper_point():
    """The noiseless paper point (16 rows, 4-bit ADC, cutoff 0.5) on the
    committed checkpoint, 64 images: the same record."""
    d = {"name": "acc", "measure": "cim-accuracy",
         "axes": {"rows_active": [16], "adc_bits": [4], "cutoff": [0.5],
                  "noisy": [False]},
         "params": {"n_images": 64}}
    ref = JSweepConfig.from_dict(d)
    port = SweepConfig.from_dict(
        {**d, "params": {**d["params"], "device": "cpu"}})
    from repro.sweep import plan as jplan

    want = jmeasures.resolve("cim-accuracy").fn(ref, jplan.expand(ref)[0])
    got = measures.resolve("cim-accuracy").fn(port, plan.expand(port)[0])
    assert got == want


def _smoke_spread(seeds=range(10, 16)):
    """Per-(vdd) sd of the projected mean score over single-draw port
    sweeps of ci_smoke's layers (the same numpy-seeded layers, noise
    seeds 10-15)."""
    from repro_torch.core import calibrate as cal
    from repro_torch.core.pipeline import default_pipeline

    rng = np.random.default_rng(0)
    weights = {"l1": rng.normal(size=(32, 8)) * 0.1,
               "l2": rng.normal(size=(16, 8)) * 0.1}
    acts = {k: np.maximum(rng.normal(size=(32, w.shape[0])), 0)
            for k, w in weights.items()}

    def t(tree):
        return {k: torch.from_numpy(v.astype(np.float32))
                for k, v in tree.items()}

    grid = cal.CalibrationGrid(variants=("p8t",), vdd=(0.6, 0.9),
                               **measures.SMOKE_GRID_KW)
    scores = {0.6: [], 0.9: []}
    for s in seeds:
        r = cal.calibrate(default_pipeline(), t(weights), t(acts), grid,
                          n_noise_keys=1, seed=s)
        for v in scores:
            proj = r.project("p8t", vdd=v)
            scores[v].append(np.mean([lc.score
                                      for lc in proj.layers.values()]))
    return {v: float(np.std(s, ddof=1)) for v, s in scores.items()}


def test_ci_smoke_end_to_end_matches_reference(tmp_path):
    ref, port = _pair("ci_smoke.json", tmp_path)
    port = port.override(params={"device": "cpu"})
    jrunner.run(ref, log=lambda _s: None)
    runner.run(port, log=lambda _s: None)
    from repro.sweep import analysis as janalysis

    want = json.loads(janalysis.analyze(ref)[0].read_text())
    got = report.load_report(analysis.analyze(port)[0])
    for key in ("version", "model", "cost_unit", "slack", "grid"):
        assert got[key] == want[key], key
    sd = _smoke_spread()
    assert len(got["points"]) == len(want["points"]) == 2
    for g, w in zip(got["points"], want["points"]):
        for key in ("variant", "vdd", "tops_per_w", "frontier"):
            assert g[key] == w[key], key
        tol = 5 * np.sqrt(2 / 2) * max(sd[w["vdd"]], 0.02 * w["score"]) \
            + 1e-6
        assert abs(g["score"] - w["score"]) <= tol, (g, w, tol)
        assert abs(g["accuracy"] - w["accuracy"]) <= 2 * tol, (g, w, tol)
