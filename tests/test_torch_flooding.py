"""The flooding schedule: the port against the JAX package.

The same inputs, made from a seeded numpy generator or the JAX channel,
go through ``ems_nbldpc_tpu/decoder/flooding.py`` and the port.

* ``checknode`` on the same min-normalized VtoC messages: EMS and min-sum
  bit for bit; SPA within the SPA tolerance of ``tests/test_torch_spa.py``
  (exp(-cost) within 1e-5 everywhere, costs within 1e-3 where the JAX cost
  is <= 8), since the port sums the transform in another order.
* Whole decodes: identical decisions, iteration counts and convergence.
  ``cn_impl="pallas"`` runs the CUDA kernel's plain version on CPU
  tensors; the JAX side runs ``topk`` (the Pallas kernel's own exact
  reference), or its Pallas kernel in interpret mode in one small case.
* The Monte-Carlo chains draw different random streams, so they agree in
  distribution: their FER Wilson 95% intervals must overlap.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ems_nbldpc_tpu.ops.pallas_cn as jpallas
from ems_nbldpc_tpu.decoder import flooding as jflooding
from ems_nbldpc_tpu.decoder.api import DecoderConfig as JConfig
from ems_nbldpc_tpu.decoder.api import decode as jdecode
from ems_nbldpc_tpu.decoder.graph import DeviceGraph as JGraph
from ems_nbldpc_tpu.models.channels import ChannelSpec, bpsk_awgn, sigma_for
from ems_nbldpc_tpu.models.code import from_parsed as jfrom_parsed
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular
from ems_nbldpc_tpu.models.encoder import \
    gaussian_elimination as jgaussian_elimination
from ems_nbldpc_tpu.models.formats import ParsedMatrix as JParsedMatrix
from ems_nbldpc_tpu.sim.mc import MonteCarlo as JMonteCarlo
from ems_nbldpc_tpu.sim.mc import SimConfig as JSimConfig

from ems_nbldpc_torch.decoder import flooding
from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.graph import DeviceGraph
from ems_nbldpc_torch.models.code import from_jax_code
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig
from ems_nbldpc_torch.utils.stats import overlapping


def tiny_irregular():
    """The hand-built GF(16) code of ``tests/test_decoder_e2e.py``: rows of
    degree 3 and 2, so padded row slots."""
    rows = [np.array([0, 1, 2]), np.array([1, 3]), np.array([0, 3, 4]),
            np.array([2, 4])]
    coefs = [np.array([1, 3, 7]), np.array([2, 5]), np.array([4, 9, 1]),
             np.array([6, 8])]
    return jfrom_parsed(JParsedMatrix(5, 4, 16, rows, coefs),
                        name="tiny_irr")


def irregular16():
    """Rows of degree 3, 4 and 5 and columns of degree 1 to 3, so padded
    row slots and padded column slots (``col_edges`` = E)."""
    rows = [[0, 1, 2, 3], [4, 5, 6], [7, 8, 9, 10, 11], [12, 13, 14, 15],
            [0, 4, 7, 12, 1], [2, 5, 8, 13], [3, 6, 9, 14, 10],
            [11, 15, 1, 5]]
    rng = np.random.default_rng(0)
    coefs = [rng.integers(1, 16, len(r)) for r in rows]
    return jfrom_parsed(JParsedMatrix(16, len(rows), 16,
                                      [np.asarray(r) for r in rows], coefs),
                        name="irregular16")


CODES = {
    "regular": lambda: jrandom_regular(48, 24, 16, seed=3),
    "irregular": tiny_irregular,
}

BRANCHES = {  # name: (cn, nm, port cn_impl, JAX cn_impl)
    "ems-topk": ("ems", 5, "topk", "topk"),
    "ems-pallas": ("ems", 5, "pallas", "topk"),
    "minsum-dense": ("minsum", 0, "auto", "auto"),
    "spa": ("spa", 0, "auto", "auto"),
}


def min_normalized(shape, seed):
    v = (np.random.default_rng(seed).random(shape) * 9).astype(np.float32)
    return v - v.min(axis=-1, keepdims=True)


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("code", list(CODES))
def test_checknode_matches_jax(code, branch):
    jc = CODES[code]()
    cn, nm, impl, jimpl = BRANCHES[branch]
    vtoc = min_normalized((6, jc.n_edges, jc.q), seed=len(branch))
    want = np.asarray(jflooding.checknode(JGraph.from_code(jc),
                                          jnp.asarray(vtoc), nm, 0.3, cn,
                                          jimpl))
    got = flooding.checknode(DeviceGraph.from_code(from_jax_code(jc)),
                             torch.from_numpy(vtoc), nm, 0.3, cn,
                             impl).numpy()
    assert (got.min(axis=-1) == 0).all()
    if cn != "spa":
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(np.exp(-got), np.exp(-want), rtol=0,
                               atol=1e-5)
    likely = want <= 8
    np.testing.assert_allclose(got[likely], want[likely], rtol=0, atol=1e-3)


def jax_frames(jc, f, ebn0, seed):
    """Codewords (numpy back-substitution) and intrinsics from the JAX
    channel."""
    enc = jgaussian_elimination(jc)
    info = np.random.default_rng(seed).integers(0, jc.q, (f, jc.k))
    cw = enc.encode_np(info)
    sigma = sigma_for(ChannelSpec(), ebn0, jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(seed), jnp.asarray(cw, jnp.int32),
                        jc.q, sigma)
    return cw, np.array(intr)


@functools.lru_cache(maxsize=None)
def jax_decode(code, cn, nm, ebn0):
    jc = (jrandom_regular(96, 48, 16, seed=0) if code == "regular"
          else irregular16())
    cw, intr = jax_frames(jc, 32, ebn0, seed=4)
    jcfg = JConfig(max_iters=15, schedule="flooding", cn=cn, nm=nm,
                   offset=0.3, cn_impl="topk" if cn == "ems" else "auto",
                   loop="host")
    want = [np.asarray(x) for x in jdecode(jc, jnp.asarray(intr), jcfg)]
    return jc, cw, intr, jcfg, want


@pytest.mark.parametrize("code,cn,nm,impl,ebn0", [
    ("regular", "ems", 8, "pallas", 1.5), ("regular", "ems", 8, "topk", 1.5),
    ("regular", "ems", 8, "auto", 1.5), ("regular", "minsum", 0, "auto", 1.5),
    ("irregular", "ems", 6, "pallas", 2.0),
    ("irregular", "minsum", 0, "auto", 2.0),
])
def test_decode_matches_jax(code, cn, nm, impl, ebn0):
    jc, cw, intr, jcfg, want = jax_decode(code, cn, nm, ebn0)
    # informative: some frames need several iterations, some converge, and
    # on the regular code converged frames decode to the codeword (the
    # irregular one is small enough to have near codewords)
    assert want[1].max() > 1 and want[2].any()
    if code == "regular":
        assert (want[0][want[2]] == cw[want[2]]).all()
    cfg = DecoderConfig(**dict(dataclasses.asdict(jcfg), cn_impl=impl))
    got = decode(from_jax_code(jc), torch.from_numpy(intr), cfg)
    for name, a, b in zip(("decide", "iters", "conv"), got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_decode_matches_jax_pallas_interpret(monkeypatch):
    """The JAX side runs its Pallas kernel itself, in interpret mode, on
    a code of two row layers at nm = 4."""
    monkeypatch.setattr(
        jpallas, "fb_checknode_pallas",
        functools.partial(jpallas.fb_checknode_pallas, tile=16,
                          interpret=True))
    jc = jrandom_regular(16, 8, 16, seed=0)
    assert len(jc.layers) == 2
    _, intr = jax_frames(jc, 4, 2.0, seed=0)
    jcfg = JConfig(max_iters=4, schedule="flooding", cn="ems", nm=4,
                   offset=0.3, cn_impl="pallas", loop="host")
    want = [np.asarray(x) for x in jdecode(jc, jnp.asarray(intr), jcfg)]
    assert want[1].max() > 1 and want[2].any()
    got = decode(from_jax_code(jc), torch.from_numpy(intr),
                 DecoderConfig(**dataclasses.asdict(jcfg)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_converged_frames_are_frozen():
    jc = jrandom_regular(96, 48, 16, seed=5)
    _, intr = jax_frames(jc, 32, 1.5, seed=5)
    g = DeviceGraph.from_code(from_jax_code(jc))
    init, step = flooding.make_flooding_stepper(g, 8, 0.3, "ems", "pallas")
    state = init(torch.from_numpy(intr))
    for _ in range(15):          # step until some, not all, frames converged
        state = step(state)
        conv = state[3].clone()
        if conv.any() and not conv.all():
            break
    assert conv.any() and not conv.all()
    ctov, decide, iters = (state[i][conv].clone() for i in (1, 2, 4))
    state = step(state)
    assert torch.equal(state[1][conv], ctov)
    assert torch.equal(state[2][conv], decide)
    assert torch.equal(state[4][conv], iters)
    assert (state[4][~conv] > iters.max()).all()
    assert (state[1][:, -1] == 0).all()          # the padding edge stays 0


def test_fer_ci_overlaps_jax():
    dec = dict(max_iters=10, schedule="flooding", cn="ems", nm=8,
               offset=0.3, loop="host")
    jc = jrandom_regular(96, 48, 16, seed=0)
    sim = dict(ebn0_db=2.0, frames_per_batch=64, max_frames=128,
               stop_errors=10**9)
    jres = JMonteCarlo(jc, JSimConfig(
        decoder=JConfig(cn_impl="topk", **dec), **sim)).run()
    tres = MonteCarlo(from_jax_code(jc), SimConfig(
        decoder=DecoderConfig(cn_impl="pallas", **dec), **sim),
        device="cpu").run()
    assert tres.frames == jres.frames == 128
    assert 0 < tres.frame_errors < tres.frames      # an informative point
    assert overlapping(tres.frame_errors, tres.frames,
                       jres.frame_errors, jres.frames), (
        tres.fer_ci, jres.fer_ci)
    assert 1 < tres.avg_iters < 10
    assert tres.decoder_steps <= 2 * 10


@pytest.mark.cuda
def test_flooding_kernels_match_plain_on_card():
    """Flooding decodes through both CUDA kernels against their plain
    versions on the same card (card only; chip_smoke.py runs the
    full-width comparison): EMS identical, SPA identical in decisions and
    convergence with iterations within 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from ems_nbldpc_torch.ops import cuda_cn, cuda_spa

    jc = jrandom_regular(96, 48, 16, seed=0)
    _, intr = jax_frames(jc, 32, 1.5, seed=4)
    g = DeviceGraph.from_code(from_jax_code(jc))
    x = torch.from_numpy(intr).cuda()
    before = cuda_cn.launches
    kern = flooding.decode_flooding_hostloop(g, x, 15, 8, 0.3, "ems",
                                             "pallas")
    assert cuda_cn.launches - before == int(kern[1].max()) > 0
    plain = flooding.decode_flooding_hostloop(g, x, 15, 8, 0.3, "ems",
                                              "pallas", plain=True)
    assert all(torch.equal(a, b) for a, b in zip(kern, plain))
    before = cuda_spa.launches
    kern = flooding.decode_flooding_hostloop(g, x, 15, cn="spa")
    assert cuda_spa.launches - before == int(kern[1].max()) > 0
    plain = flooding.decode_flooding_hostloop(g, x, 15, cn="spa",
                                              plain=True)
    assert torch.equal(kern[0], plain[0]) and torch.equal(kern[2], plain[2])
    assert int((kern[1] - plain[1]).abs().max()) <= 1
