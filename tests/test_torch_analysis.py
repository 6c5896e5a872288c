"""The JAX package's linter and range certifier (``repro.analysis``, which
imports no JAX) over the port as it is: strict mode reports no finding
(its registry rule reads one literal ``register_kernel(KernelKey(...))``
per key in ``kernels/dispatch.py``), and every ``# bound:`` site of the
port is proved at every committed geometry, none violated or unproved.
The certificate goes to a temporary file, never to the committed one.
"""

import contextlib
import io
import json
import pathlib

import pytest

from repro.analysis import cli

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    cert = tmp_path_factory.mktemp("analysis") / "certificate.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main([str(PORT), "--strict", "--format", "json",
                         "--certificate", str(cert)])
    return code, json.loads(buf.getvalue()), json.loads(cert.read_text())


def test_strict_reports_no_finding(report):
    code, rep, _ = report
    assert rep["findings"] == [], rep["findings"]
    assert rep["counts"]["new"] == rep["counts"]["stale_baseline"] == 0
    assert code == 0


def test_every_certificate_site_is_proved(report):
    _, _, cert = report
    counts = cert["counts"]
    assert counts["proved"] == len(cert["sites"]) > 0
    assert counts["violated"] == counts["unproved"] == 0
    assert counts["geometries"] == len(cert["geometries"]) == 27
    for site in cert["sites"]:
        assert site["path"].startswith("src/repro_torch/"), site["path"]
        assert site["status"] == "proved" and not site["failures"], site
        assert len(site["proofs"]) == counts["geometries"], site["expr"]
