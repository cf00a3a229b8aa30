"""On the card: a short traced run of ``spa_row.1p8dB`` reads the marker
spans, and they add up with the split batches' CUDA events (gen's work
does not depend on the batch; the decisions and the syndrome are part of
the decode).  Run there with ``python3 -m pytest simbench/tests -m cuda
-q``."""
import json
import os
import subprocess
import sys

import pytest

from simbench import spec

SPANS = ("encode_ms", "channel_ms", "decide_ms", "syndrome_ms")


@pytest.mark.cuda
def test_traced_run_reads_the_marker_spans():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "simbench.run", "--workload", "spa_row.1p8dB",
         "--seed", "2147483677", "--seconds", "3", "--trace", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(SPANS) <= set(m), sorted(m)
    gen = m["encode_ms"] + m["channel_ms"]
    assert abs(gen - m["gen_ms"]) <= 0.03 * m["gen_ms"], m
    assert m["decide_ms"] + m["syndrome_ms"] < m["decode_ms"], m
