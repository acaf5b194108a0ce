"""On the card: each cell, shrunk, through a traced run (run with
`python -m pytest -m cuda chipbench/tests` there)."""
import time

import pytest

from chipbench import harness
from chipbench.tests.conftest import TINY


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TINY))
def test_traced_run_on_the_card(cuda_device, name):
    result, out, err = harness.run(
        name, 2 ** 31 + 23, 0.5, True, cuda_device, time.perf_counter(),
        traffic=dict(TINY[name], trace_batches=20))
    assert result["correct"], err
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    spec = harness.cell(name)
    assert set(result["metrics"]) == {m["name"] for m in spec.per_layer}
    assert "per batch rb 1, generic 0" in out[0]
    assert 0 < result["metrics"]["cnn_eq_roofline"]["value"] <= 100
