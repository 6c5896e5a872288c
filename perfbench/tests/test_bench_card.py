"""Each cell once on the card, briefly, through the benchmark's command
path (``harness.main``): a result line, correct, with every metric. Skips
without a CUDA device."""

import json
import time

import pytest

from perfbench import harness

CELLS = ["resnet20-cifar.eval-b256", "qwen2-0.5b.decode-b4",
         "qwen2-0.5b.prefill-b4x1024"]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload, trace, capsys):
    rc = harness.main(["--workload", workload, "--seed", str(2**31 + 5),
                       "--seconds", "3", "--trace", str(trace)],
                      time.perf_counter())
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    result = json.loads(out[-1])
    assert result["correct"], result["checks"]
    spec = harness.load_cell(workload)
    want = spec["per_layer"] if trace else spec["end_to_end"]
    assert set(result["metrics"]) == {m["name"] for m in want}
    assert result["device"]["platform"] == "gpu"
