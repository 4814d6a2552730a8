"""On a card: a tiny run through the kernels, traced, so that the device
readers find operations to read. Skips where there is no card."""

import time

import pytest
import torch

from genobench import run
from genobench.tests.tiny import CELLS, SITES, tiny_cell


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_on_card(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = run.measure(tiny_cell(name), 23, 0.5, True, "cuda", str(tmp_path),
                      time.perf_counter(), SITES)
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0
    assert {"device.idle_share", "device.ops_per_batch",
            "vote_roofline"} <= set(res["metrics"])
    assert 0 < res["metrics"]["vote_roofline"]["value"] <= 100
