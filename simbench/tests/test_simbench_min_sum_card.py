"""On the card: the min-sum cell's decoder step as the device loop runs it
(K1 three launches a step, all replayed from the graph, none eager; the
sweep marker once a step), and a short traced run of the cell through the
entry point (``correct`` true, K1's roofline share and the sweep's time
read).  Run there with ``python3 -m pytest simbench/tests -m cuda -q``."""
import gc
import json
import os
import subprocess
import sys

import pytest

from simbench import harness, spec
from simbench.codes import make as make_matrix

CELL = "min_sum_row.1p8dB"
SEED = 2147483659


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch


@pytest.mark.cuda
def test_k1_launches_and_sweep_markers_a_step(card):
    from ems_nbldpc_torch.ops import cuda_cn

    cell = spec.cell(CELL)
    harness.profiler_warm()                    # before any graph is made
    prog = harness.imported_program()
    rows, coefs = make_matrix(cell["config"]["code"])
    code = harness.make_code(prog, cell, rows, coefs)
    step, mc = harness.stepper(prog, code, cell, 5, "cuda")
    try:
        for b in range(2):                     # the capture and a warm-up
            step(b).cpu()
        cuda_cn.launches = 0
        cuda_cn.reset_device_launches()
        steps = sum(int(step(b).cpu()[5]) for b in range(2, 5))
        assert cuda_cn.device_launches() == 3 * steps
        assert cuda_cn.launches == 0
        prof = harness.start_profile()
        steps = sum(int(step(b).cpu()[5]) for b in (5, 6))
        names = [name for _, _, name in harness.stop_profile(prof)["kernels"]]
        assert sum("nbldpc_mark_sweep" in n for n in names) == steps
        assert sum("nbldpc_mark_decide" in n for n in names) == steps
        assert sum("ems_rows_kernel" in n for n in names) == 3 * steps
    finally:
        del step, mc
        prog["device_loop"].clear()
        gc.collect()
        card.cuda.empty_cache()


@pytest.mark.cuda
def test_traced_run_is_correct_and_reads_k1_and_the_sweep(card):
    out = subprocess.run(
        [sys.executable, "-m", "simbench.run", "--workload", CELL,
         "--seed", str(SEED), "--seconds", "3", "--trace", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    for name in ("k1_roofline_pct", "ems_sweep_ms"):
        assert line["metrics"][name]["value"] is not None, line["metrics"]
