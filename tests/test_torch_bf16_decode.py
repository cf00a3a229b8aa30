"""Dense bf16 storage: every dense CN family's decode against the JAX
package at ``dtype="bfloat16"``, on both schedules.

The same intrinsics (the JAX channel's, as numpy) go to both packages.
Both hold the state in bf16, but they round at different places: the port
widens the state to f32 where a step reads it and rounds once where it
writes it; JAX computes some steps in bf16 (mvc = APP - CtoV, the
normalisations) and others in f32 (its SPA transform), and XLA on the CPU
may keep f32 inside a fusion of bf16 ops.  So a decode is held by its
decisions on the frames both sides converge, with at least half the
frames converging on each side, and likewise the port at bf16 against the
port at f32.  ``cn_impl="pallas"`` (against JAX's Pallas kernel in
interpret mode) and the Monte-Carlo FER agreement are in
``tests/test_torch_bf16_layer.py``, so that the two files take about the
same time.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ems_nbldpc_tpu.decoder.api import DecoderConfig as JConfig
from ems_nbldpc_tpu.decoder.api import decode as jdecode
from ems_nbldpc_tpu.models.channels import ChannelSpec, bpsk_awgn, sigma_for
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular

from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.models.code import from_jax_code

FAMILIES = {  # name -> decoder fields
    "ems topk": dict(cn="ems", nm=8, cn_impl="topk"),
    "minsum dense": dict(cn="minsum", nm=0, cn_impl="dense"),
    "spa": dict(cn="spa", nm=0),
    "syndrome": dict(cn="syndrome", nm=8),
    "bubble": dict(cn="ems", nm=8, nboper=16, cn_impl="bubble"),
    "lbubble": dict(cn="ems", nm=8, nboper=16, cn_impl="lbubble"),
}
CASES = [(s, name) for s in ("layered", "flooding") for name in FAMILIES
         if not (s == "flooding" and name == "spa")]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread for these small decodes: the suite runs
    in parallel workers, each of which would otherwise spin a thread per
    core on tiny ops (and CPU reductions then also repeat bit for bit)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def frames(n, m, q, f, ebn0, seed):
    """(JAX code, intrinsics of its all-zero codeword) through the JAX
    channel."""
    jc = jrandom_regular(n, m, q, seed=seed)
    sigma = sigma_for(ChannelSpec(), ebn0, jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(seed), jnp.zeros((f, n), jnp.int32),
                        q, sigma)
    return jc, np.array(intr)


def converged_equal(got, want, what):
    """Decisions equal on the frames both decodes converged, at least half
    of them on each side."""
    (d1, _, c1), (d2, _, c2) = got, want
    f = len(c1)
    assert c1.sum() >= f // 2 and c2.sum() >= f // 2, (what, c1.sum(),
                                                       c2.sum())
    both = c1 & c2
    np.testing.assert_array_equal(d1[both], d2[both], err_msg=what)


@pytest.mark.parametrize("schedule,name", CASES)
def test_dense_bf16_decode_matches_jax(schedule, name):
    """(c): port bf16 against JAX bf16, and against port f32, on decisions
    of frames both converge; the host loop."""
    jc, intr = frames(48, 24, 16, 32, 2.0, seed=1)
    cfg = DecoderConfig(max_iters=10, schedule=schedule, offset=0.3,
                        loop="host", dtype="bfloat16", **FAMILIES[name])
    want = [np.asarray(x) for x in jdecode(
        jc, jnp.asarray(intr), JConfig(**dataclasses.asdict(cfg)))]
    code = from_jax_code(jc)
    got = [x.numpy() for x in decode(code, torch.from_numpy(intr), cfg)]
    f32 = [x.numpy() for x in decode(
        code, torch.from_numpy(intr), dataclasses.replace(cfg,
                                                          dtype="float32"))]
    assert got[0].dtype == np.int64 and got[1].dtype == np.int32
    converged_equal(got, want, f"{schedule} {name}: port vs JAX")
    converged_equal(got, f32, f"{schedule} {name}: bf16 vs f32")
    assert got[1].max() > 1                            # informative
