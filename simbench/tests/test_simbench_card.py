"""On the card: one short run of each one-card cell through the entry
point, ``correct`` true.  Run there with
``python3 -m pytest simbench/tests -m cuda -q``."""
import json
import os
import subprocess
import sys

import pytest

from simbench import spec

ONE_CARD = [w["name"] for w in spec.benchmark()["workloads"]
            if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "simbench.run", "--workload", cell,
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
