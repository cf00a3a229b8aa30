"""Timing helpers, binomial intervals and decoder statistics: the port
against the JAX package.

* ``binomial_ci`` / ``wilson_ci``: equal to JAX's over a grid of (k, n),
  n = 0 included.
* ``timer`` accumulates into a sink; ``trace`` writes a Chrome trace.
* ``decode_flooding_stats``: the same intrinsic (the JAX BPSK channel from
  a seed, as numpy) through JAX's and the port's; the convergence trace,
  the iteration counts, the winner-rank histogram and the mean iterations
  exactly equal, for EMS (truncated), min-sum, and ``cn_impl="pallas"``
  (the CUDA kernel's plain version on CPU tensors; on the JAX side its
  Pallas kernel in interpret mode).
* The histogram's frame chunks change no count.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ems_nbldpc_tpu.ops.pallas_cn as jpallas
from ems_nbldpc_tpu.decoder.graph import DeviceGraph as JGraph
from ems_nbldpc_tpu.decoder.stats import \
    decode_flooding_stats as jdecode_flooding_stats
from ems_nbldpc_tpu.models.channels import ChannelSpec, bpsk_awgn, sigma_for
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular
from ems_nbldpc_tpu.utils import binomial_ci as jbinomial_ci
from ems_nbldpc_tpu.utils import wilson_ci as jwilson_ci

from ems_nbldpc_torch.decoder import stats
from ems_nbldpc_torch.decoder.graph import DeviceGraph
from ems_nbldpc_torch.models.code import from_jax_code
from ems_nbldpc_torch.utils import binomial_ci, wilson_ci
from ems_nbldpc_torch.utils.timing import timer, trace


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread for these small decodes: the suite runs
    in parallel workers, each of which would otherwise spin a thread per
    core on tiny ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_binomial_ci_equals_jax():
    for n in range(0, 41):
        for k in range(0, n + 1):
            for z in (1.0, 1.96, 2.576):
                assert binomial_ci(k, n, z) == jbinomial_ci(k, n, z)
                assert wilson_ci(k, n, z) == jwilson_ci(k, n, z)
    assert binomial_ci(0, 0) == (0.0, 1.0)


def test_timer_sink_accumulates(capsys):
    sink = {}
    x = torch.ones(4)
    with timer("a", sink, sync=x):
        pass
    first = sink["a"]
    with timer("a", sink, sync=[x, x]):
        sum(range(10**5))
    assert sink["a"] > first > 0 and list(sink) == ["a"]
    with timer("b"):
        pass
    assert capsys.readouterr().out.startswith("[b] ")


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(tmp_path / "tr")
    assert name.startswith("trace_") and name.endswith(".json")
    with open(tmp_path / "tr" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert len(prof.key_averages()) > 0


@functools.lru_cache(maxsize=None)
def frames(n, m, q, f, ebn0, seed):
    """A JAX code and the BPSK intrinsic of the all-zero word (numpy)."""
    jc = jrandom_regular(n, m, q, seed=seed)
    sigma = sigma_for(ChannelSpec(), ebn0, jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(seed),
                        jnp.zeros((f, n), jnp.int32), q, sigma)
    return jc, np.array(intr)


STATS_CASES = {  # name: (code and frames, max_iters, nm, cn, cn_impl)
    "ems": ((48, 24, 64, 64, 2.5, 1), 8, 16, "ems", "auto"),
    "minsum": ((48, 24, 64, 64, 2.5, 1), 8, 0, "minsum", "auto"),
    "pallas": ((16, 8, 16, 8, 2.0, 0), 4, 4, "ems", "pallas"),
}


@pytest.mark.parametrize("case", list(STATS_CASES))
def test_decode_flooding_stats_equals_jax(case, monkeypatch):
    shape, iters, nm, cn, impl = STATS_CASES[case]
    if impl == "pallas":
        monkeypatch.setattr(
            jpallas, "fb_checknode_pallas",
            functools.partial(jpallas.fb_checknode_pallas, tile=16,
                              interpret=True))
    jc, intr = frames(*shape)
    want = jdecode_flooding_stats(JGraph.from_code(jc), jnp.asarray(intr),
                                  iters, nm, 0.3, cn, impl)
    got = stats.decode_flooding_stats(
        DeviceGraph.from_code(from_jax_code(jc)), torch.from_numpy(intr),
        iters, nm, 0.3, cn, impl)
    # informative: frames converge over several iterations
    assert want.conv_by_iter[0] < want.conv_by_iter[-1]
    assert len(got.conv_by_iter) == iters + 1
    np.testing.assert_array_equal(got.conv_by_iter, want.conv_by_iter)
    np.testing.assert_array_equal(got.iters, want.iters)
    np.testing.assert_array_equal(got.rank_hist, want.rank_hist)
    assert got.avg_iters == want.avg_iters
    q = jc.q
    nm_eff = nm if 0 < nm < q else min(q, 32)
    assert got.rank_hist.shape == (nm_eff,) and got.rank_hist.argmax() == 0
    dc = int(jc.row_deg.max())
    assert got.rank_hist.sum() == shape[3] * jc.m_rows * q * (dc - 1)


def test_stats_without_a_step():
    """Every frame converged at the first syndrome check: no step runs, the
    trace is flat and the histogram zeros, as in JAX."""
    jc, intr = frames(48, 24, 64, 16, 12.0, 2)
    g = DeviceGraph.from_code(from_jax_code(jc))
    got = stats.decode_flooding_stats(g, torch.from_numpy(intr), 5, 16, 0.3,
                                      "ems")
    np.testing.assert_array_equal(got.conv_by_iter, [16] * 6)
    assert got.avg_iters == 0 and not got.iters.any()
    np.testing.assert_array_equal(got.rank_hist, np.zeros(16, np.int64))


def test_histogram_chunks_change_no_count():
    jc = jrandom_regular(48, 24, 64, seed=1)
    g = DeviceGraph.from_code(from_jax_code(jc))
    v = np.random.default_rng(0).random((13, g.n_edges, 64), np.float32) * 9
    v = torch.from_numpy(v - v.min(axis=-1, keepdims=True))
    hists = [stats.winner_rank_histogram(g, v, 16, chunk)
             for chunk in (1, 5, 13, None)]
    for h in hists[1:]:
        assert torch.equal(h, hists[0])
    dc = int(jc.row_deg.max())
    assert int(hists[0].sum()) == 13 * jc.m_rows * jc.q * (dc - 1)
    per_frame = jc.m_rows * 16 * jc.q * stats.HIST_ENTRY_BYTES
    chunk = stats.hist_chunk(g, 16)
    assert chunk * per_frame <= stats.HIST_BUDGET_BYTES < (chunk + 1) * per_frame
