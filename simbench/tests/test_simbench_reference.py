"""The plain reference against the port's plain CPU path on small codes,
and its controls (one precision step below) against it.  These tests
import the port to compare with it; the reference itself imports none of
it."""
import numpy as np
import pytest
import torch

from simbench.codes import make
from simbench.reference import channel, code as ref_code, encoder, list_ems, spa

SMALL = [(96, 48, 16, 1), (240, 120, 64, 3), (192, 64, 16, 2)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port_code(n, m, q, seed, dv=2):
    from ems_nbldpc_torch.models.code import random_regular
    return random_regular(n, m, q, dv=dv, seed=seed)


def small(n, m, q, seed, dv=2):
    rows, coefs = make(dict(kind="random_regular", n=n, m=m, q=q, dv=dv,
                            seed=seed))
    return rows, coefs, ref_code.build(rows, coefs, n, q)


@pytest.mark.parametrize("n,m,q,seed", SMALL + [(8100, 4050, 256, 0)])
def test_matrix_draws_equal_the_ports(n, m, q, seed):
    rows, coefs = make(dict(kind="random_regular", n=n, m=m, q=q, dv=2,
                            seed=seed))
    c = port_code(n, m, q, seed)
    assert all(np.array_equal(c.row_cols[r], rows[r]) and
               np.array_equal(c.row_coefs[r], coefs[r]) for r in range(m))


@pytest.mark.parametrize("n,m,q,seed", SMALL)
def test_layers_and_information_set_equal_the_ports(n, m, q, seed):
    from ems_nbldpc_torch.models.encoder import _gaussian_elimination_impl
    _, _, code = small(n, m, q, seed)
    c = port_code(n, m, q, seed)
    assert len(code.layers) == len(c.layers)
    assert all(np.array_equal(a, b) for a, b in zip(code.layers, c.layers))
    assert np.array_equal(encoder.information_set(code),
                          _gaussian_elimination_impl(c).perm)


def _port_batch(n, m, q, seed, dec, ebn0, frames, sim_seed=77, batch=3):
    from ems_nbldpc_torch.decoder.api import DecoderConfig
    from ems_nbldpc_torch.models.encoder import gaussian_elimination
    from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig
    c = port_code(n, m, q, seed)
    cfg = SimConfig(ebn0_db=ebn0, frames_per_batch=frames, seed=sim_seed,
                    decoder=DecoderConfig(**dec))
    mc = MonteCarlo(c, cfg, gaussian_elimination(c), device="cpu")
    cw, intr = mc.gen(batch)
    from ems_nbldpc_torch.decoder.api import decode
    return cw, intr, decode(mc.graph, intr, cfg.decoder)


SPA_DEC = dict(max_iters=12, schedule="layered", cn="spa", storage="dense",
               dtype="float32")
LIST_DEC = dict(max_iters=8, schedule="layered", cn="ems", nm=8, nboper=16,
                offset=0.3, storage="compressed", dtype="bfloat16")
EXACT_DEC = dict(LIST_DEC, nboper=0)


@pytest.mark.parametrize("fam,dec", [("spa", SPA_DEC), ("list", LIST_DEC),
                                     ("list", EXACT_DEC)])
@pytest.mark.parametrize("n,m,q,seed", SMALL[:2])
def test_batch_equals_the_ports_plain_path(fam, dec, n, m, q, seed):
    """Codewords, intrinsic costs and decodes of one batch, bit for bit."""
    ebn0, frames = 1.5, 12
    cw, intr, (d, it, cv) = _port_batch(n, m, q, seed, dec, ebn0, frames)
    _, _, code = small(n, m, q, seed)
    perm = encoder.information_set(code)
    g_info, g_chan = channel.generators(77, 3, "cpu")
    logq = q.bit_length() - 1
    info = encoder.info_symbols(
        channel.info_bits(g_info, frames, code.k, logq, "cpu"), code.k, logq)
    assert not encoder.wrong_codewords(code, perm, cw, info).any()
    sig = channel.sigma(ebn0, code.k / code.n)
    want = channel.intrinsic(channel.received(g_chan, cw, q, sig), q, sig)
    assert torch.equal(want, intr)
    mod = spa if fam == "spa" else list_ems
    rd, rit, rcv = mod.decode(code, want, dec, block=5)
    assert torch.equal(rd, d) and torch.equal(rit, it.to(rit.dtype))
    assert torch.equal(rcv, cv)
    assert int(it.max()) >= 2              # the decode did work


def test_wrong_codewords_caught():
    _, _, code = small(96, 48, 16, 1)
    perm = encoder.information_set(code)
    cw, _, _ = _port_batch(96, 48, 16, 1, SPA_DEC, 2.0, 4)
    g_info, _ = channel.generators(77, 3, "cpu")
    info = encoder.info_symbols(channel.info_bits(g_info, 4, code.k, 4, "cpu"),
                                code.k, 4)
    bad = cw.clone()
    bad[1, 7] ^= 1                          # a parity or info symbol altered
    assert encoder.wrong_codewords(code, perm, bad, info).tolist() == [
        False, True, False, False]
    other = info.clone()
    other[2, 0] ^= 3                        # another frame's information
    assert encoder.wrong_codewords(code, perm, cw, other).tolist() == [
        False, False, True, False]


def _control_differ(fam, dec, n, m, q, ebn0, frames):
    _, _, code = small(n, m, q, 1)
    cw = torch.zeros((frames, n), dtype=torch.int64)
    g = channel.generators(5, 0, "cpu")[1]
    sig = channel.sigma(ebn0, code.k / n)
    intr = channel.intrinsic(channel.received(g, cw, q, sig), q, sig)
    mod = spa if fam == "spa" else list_ems
    d, it, cv = mod.decode(code, intr, dec)
    dc, itc, cvc = mod.decode(code, intr, dec, control=True)
    return 100 * float(((d != dc).any(1) | (it != itc) | (cv != cvc))
                       .float().mean())


@pytest.mark.parametrize("fam,dec,lower", [
    ("spa", dict(SPA_DEC, max_iters=20), 5.0),
    ("list", dict(LIST_DEC, max_iters=10), 50.0)])
def test_controls_come_out_not_correct(fam, dec, lower):
    """One precision step below the configuration's (TF32 products in the
    SPA transform, float8 list storage) changes the decode of many frames
    on a small code; the intrinsic costs with a TF32 product lie ~2e-4
    from the float32 ones."""
    assert _control_differ(fam, dec, 384, 192, 64, 1.5, 32) >= lower
    y = torch.randn(8, 20, 6, generator=torch.Generator().manual_seed(1))
    a = channel.intrinsic(y, 64, 0.8)
    b = channel.intrinsic(y, 64, 0.8, tf32=True)
    assert float((a - b).abs().max() / a.abs().max()) > 1e-5


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0])
    y = channel.round_tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
