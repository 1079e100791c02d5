"""A cell run on the card, as the benchmark's command runs it (skipped
without one; the decision is made inside the test)."""

import json
import subprocess
import sys

import harness_helpers as h
import pytest


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["kitti360.train", "rgb_only.serve"])
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels run only on the card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell,
                          "--seed", "2147483711", "--seconds", "2", "--trace", "0"],
                         cwd=h.REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
