"""Bit-matmul encoder and BPSK demapper: the port against the JAX package.

Same inputs on both sides (the JAX info bits and channel outputs, handed
over as numpy).  Codewords are integer results: exact.  The demapper is a
float matmul summed in another order, hence rtol 1e-6 / atol 1e-4 (costs
reach ~1e3 at these sigmas; f32 spacing there is ~1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ems_nbldpc_tpu.models.encoder as jenc_mod
from ems_nbldpc_tpu.decoder.flooding import syndrome_ok as jsyndrome_ok
from ems_nbldpc_tpu.decoder.graph import DeviceGraph as JGraph
from ems_nbldpc_tpu.models import channels as jch
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular
from ems_nbldpc_tpu.sim import mc as jmc

import ems_nbldpc_torch.models.encoder as tenc_mod
from ems_nbldpc_torch.decoder.flooding import syndrome_ok
from ems_nbldpc_torch.decoder.graph import DeviceGraph
from ems_nbldpc_torch.models import channels as tch
from ems_nbldpc_torch.models.code import from_jax_code
from ems_nbldpc_torch.models.encoder import from_jax_encoder, syndrome_np
from ems_nbldpc_torch.sim import mc as tmc


@pytest.fixture
def fresh_caches(tmp_path, monkeypatch):
    monkeypatch.setattr(jenc_mod, "CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(tenc_mod, "CACHE_DIR", str(tmp_path / "torch"))


@pytest.mark.parametrize("n,m,q", [(64, 32, 256)])
def test_codewords_bit_exact(n, m, q, fresh_caches):
    jc = jrandom_regular(n, m, q, seed=1)
    je = jenc_mod.gaussian_elimination(jc)
    te = from_jax_encoder(je)
    f = 16
    jcfg = jmc.SimConfig(ebn0_db=2.0, frames_per_batch=f)
    make_cw, _, pmat = jmc.make_codeword_fn(jc, jcfg, je)
    kinfo = jax.random.PRNGKey(11)
    # the same bits the JAX make_codeword draws from kinfo
    bits = np.asarray(jax.random.bernoulli(kinfo, 0.5, (f, jc.k * jc.logq)))
    want = np.asarray(make_cw(kinfo, jnp.asarray(pmat)))

    tcfg = tmc.SimConfig(ebn0_db=2.0, frames_per_batch=f)
    _, encode_bits, _, tpmat = tmc.make_codeword_fn(te.code, tcfg, te)
    np.testing.assert_array_equal(tpmat, pmat)
    got = encode_bits(torch.from_numpy(bits.astype(np.uint8)),
                      torch.from_numpy(tpmat).float())
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (syndrome_np(te.code, got.numpy()) == 0).all()
    g = DeviceGraph.from_code(te.code)
    assert syndrome_ok(g, got).all()
    np.testing.assert_array_equal(
        syndrome_ok(g, got).numpy(),
        np.asarray(jsyndrome_ok(JGraph.from_code(jc), jnp.asarray(want))))
    # the info symbols sit at the systematic positions
    info = (bits.reshape(f, jc.k, jc.logq).astype(np.int64)
            << np.arange(jc.logq)).sum(-1)
    np.testing.assert_array_equal(got.numpy()[:, te.systematic_positions()],
                                  info)


def test_make_codeword_draws_codewords(fresh_caches):
    code = from_jax_code(jrandom_regular(48, 24, 16, seed=2))
    cfg = tmc.SimConfig(ebn0_db=2.0, frames_per_batch=32)
    make_cw, _, _, pmat = tmc.make_codeword_fn(code, cfg)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    gen, _ = tmc.batch_generators(5, 0, "cpu")
    cw = make_cw(gen, torch.from_numpy(pmat).float())
    assert cw.shape == (32, code.n)
    assert syndrome_ok(DeviceGraph.from_code(code), cw).all()
    assert len(np.unique(cw.numpy())) > 1
    # the same (seed, batch) gives the same frames; another batch differs
    gen2, _ = tmc.batch_generators(5, 0, "cpu")
    assert torch.equal(cw, make_cw(gen2, torch.from_numpy(pmat).float()))
    gen3, _ = tmc.batch_generators(5, 1, "cpu")
    assert not torch.equal(cw, make_cw(gen3, torch.from_numpy(pmat).float()))


@pytest.mark.parametrize("q", [16, 256])
@pytest.mark.parametrize("ebn0", [0.5, 3.0])
def test_intrinsic_from_bpsk_matches(q, ebn0):
    rate = 0.5
    sigma = jch.sigma_for(jch.ChannelSpec(), ebn0, rate)
    assert tch.sigma_for(tch.ChannelSpec(), ebn0, rate) == pytest.approx(
        sigma, rel=1e-15)
    rng = np.random.default_rng(int(ebn0 * 10) + q)
    cw = jnp.asarray(rng.integers(0, q, (8, 40)), jnp.int32)
    want, y = jch.bpsk_awgn(jax.random.PRNGKey(3), cw, q, sigma)
    got = tch.intrinsic_from_bpsk(torch.from_numpy(np.array(y)), q, sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-4)
    assert (got.min(dim=-1).values == 0).all()


def test_bpsk_awgn_noise_and_decisions():
    q, sigma = 64, 0.8
    cw = torch.from_numpy(np.random.default_rng(0).integers(0, q, (64, 100)))
    gen = torch.Generator().manual_seed(1)
    intr, y = tch.bpsk_awgn(gen, cw, q, sigma)
    assert intr.shape == (64, 100, q) and y.shape == (64, 100, 6)
    tx = 1.0 - 2.0 * ((cw[..., None] >> torch.arange(6)) & 1).float()
    noise = (y - tx) / sigma
    assert abs(float(noise.mean())) < 0.02
    assert abs(float(noise.std()) - 1.0) < 0.02
    # hard decisions of a noiseless channel are the codeword itself
    clean = tch.intrinsic_from_bpsk(tx, q, sigma)
    assert torch.equal(clean.argmin(dim=-1), cw)


def test_simulate_other_channels_raise():
    """The other channels run; a q or labeling their tables cannot serve
    raises ValueError (tests/test_torch_channels.py has the rest)."""
    cw = torch.zeros((2, 8), dtype=torch.int64)
    gen = torch.Generator().manual_seed(0)
    for kind, q in (("qam", 16), ("apsk64", 64), ("qam256_4d", 256)):
        cost = tch.simulate(gen, cw, q, tch.ChannelSpec(kind=kind), 2.0, 0.5)
        assert cost.shape == (2, 8, q)
        with pytest.raises(ValueError, match="q"):
            tch.simulate(gen, cw, 32, tch.ChannelSpec(kind=kind), 2.0, 0.5)
        with pytest.raises(ValueError, match="labeling"):
            tch.simulate(gen, cw, q, tch.ChannelSpec(kind=kind,
                                                     labeling="x"), 2.0, 0.5)
