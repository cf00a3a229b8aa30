"""The truncated-list EMS path: the port against the JAX package.

Inputs are made from a seeded numpy generator and fed to both packages.
On f32 inputs every list op is exact (sums are single f32 adds, the
selections are sorts of unique packed keys, the dedup and rotations are
integer logic), so the list ops and the whole list decode at
``dtype="float32"`` must agree bit for bit; "ties" inputs draw a few
integer levels, so equal values (and their tie order) matter.  At
``bfloat16`` the two frameworks round at different places (XLA on the CPU
may keep f32 inside a fusion of bf16 ops, torch rounds after every op), so
the decode is held by decisions on the frames both converged and by the
overlap of Monte-Carlo FER Wilson intervals.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ems_nbldpc_tpu.decoder.api import DecoderConfig as JConfig
from ems_nbldpc_tpu.decoder.api import decode as jdecode
from ems_nbldpc_tpu.gf import get_gf as jget_gf
from ems_nbldpc_tpu.models.channels import ChannelSpec, bpsk_awgn, sigma_for
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular
from ems_nbldpc_tpu.ops import listcn as jl
from ems_nbldpc_tpu.ops import minconv as jmc
from ems_nbldpc_tpu.sim.mc import MonteCarlo as JMonteCarlo
from ems_nbldpc_tpu.sim.mc import SimConfig as JSimConfig

from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.gf import get_gf
from ems_nbldpc_torch.models.code import from_jax_code
from ems_nbldpc_torch.ops import listcn as tl
from ems_nbldpc_torch.ops import minconv as tmc
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig
from ems_nbldpc_torch.utils.stats import overlapping


def dense(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(0, 6, shape).astype(np.float32)
    return (rng.random(shape) * 9).astype(np.float32)


def lists(shape, q, nm, kind, seed, unfilled=0):
    """Sorted (values, ids) lists from dense messages via JAX topk_list;
    the last ``unfilled`` slots of every list are BIG (unfilled)."""
    v, g = jl.topk_list(jnp.asarray(dense(shape + (q,), kind, seed)), nm)
    v, g = np.array(v), np.array(g)
    if unfilled:
        v[..., nm - unfilled:] = 1e9
    return v, g


def same(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("q", [16, 256])
def test_mul_cols_and_rotate_ids_exact(q):
    rng = np.random.default_rng(q)
    coefs = rng.integers(0, q, (5, 4))
    coefs[0, 0] = 0
    for inverse in (False, True):
        want = jl.mul_cols(jget_gf(q), coefs, inverse)
        cols = tl.mul_cols(get_gf(q), coefs, inverse)
        np.testing.assert_array_equal(cols, want)
        ids = rng.integers(0, q, (3, 5, 4, 8)).astype(np.int32)
        np.testing.assert_array_equal(
            tl.rotate_ids(t(ids), t(cols)[None]).numpy(),
            np.asarray(jl.rotate_ids(jnp.asarray(ids), jnp.asarray(want)[None])))
    # rotation by h then by h^-1 is the identity on nonzero coefficients
    ids = t(rng.integers(0, q, (5, 4, 8)).astype(np.int32))
    fwd = t(tl.mul_cols(get_gf(q), coefs))
    back = t(tl.mul_cols(get_gf(q), coefs, inverse=True))
    nz = t(coefs != 0)[..., None]
    rt = tl.rotate_ids(tl.rotate_ids(ids, fwd), back)
    assert torch.equal(rt[nz.expand_as(rt)], ids[nz.expand_as(ids)])


@pytest.mark.parametrize("q,nm,kind", [(16, 5, "ties"), (64, 16, "uniform"),
                                       (256, 32, "ties"), (256, 32, "uniform")])
def test_topk_list_and_neutral_exact(q, nm, kind):
    x = dense((6, 4, q), kind, seed=q + nm)
    x[0, 0, :] = 0.0                                   # all tied
    x[1, 0, 3] = 2e9                                   # clamped at BIG
    same(tl.topk_list(t(x), nm), jl.topk_list(jnp.asarray(x), nm))
    same(tl.neutral_list((2, 3), nm), jl.neutral_list((2, 3), nm))


COMBINE = [  # na, nb, nm, nboper, kind, unfilled
    (8, 8, 8, 0, "ties", 0),
    (8, 8, 8, 0, "uniform", 3),
    (2, 3, 8, 0, "ties", 0),        # na * nb < nm: neutral padding
    (32, 32, 32, 64, "ties", 0),    # the bench's budget: 216 candidates
    (32, 32, 32, 64, "uniform", 10),
    (8, 8, 8, 20, "ties", 0),
    (2, 3, 8, 64, "ties", 0),       # width < nm: dup-marker padding
]


@pytest.mark.parametrize("na,nb,nm,nboper,kind,unfilled", COMBINE)
def test_list_combine_exact(na, nb, nm, nboper, kind, unfilled):
    q = 256 if max(na, nb) > 16 else 16
    av, ag = lists((5, 3), q, na, kind, seed=na + nm, unfilled=unfilled)
    bv, bg = lists((5, 3), q, nb, kind, seed=nb + nm + 1)
    want = jl.list_combine(*(jnp.asarray(x) for x in (av, ag, bv, bg)), nm,
                           nboper)
    got = tl.list_combine(t(av), t(ag), t(bv), t(bg), nm, nboper)
    same(got, want)
    assert got[0].shape == (5, 3, nm)


@pytest.mark.parametrize("dc,q,nm,nboper,kind", [
    (1, 16, 4, 0, "ties"), (2, 16, 4, 0, "ties"), (3, 16, 6, 0, "ties"),
    (4, 256, 32, 64, "ties"), (4, 256, 32, 64, "uniform"),
    (6, 64, 8, 0, "uniform"), (5, 64, 12, 24, "ties")])
def test_fb_checknode_list_exact(dc, q, nm, nboper, kind):
    bv, bg = lists((4, 3, dc), q, nm, kind, seed=dc * q + nm)
    want = jl.fb_checknode_list(jnp.asarray(bv), jnp.asarray(bg), nm, nboper)
    got = tl.fb_checknode_list(t(bv), t(bg), nm, nboper)
    same(got, want)


@pytest.mark.parametrize("q,nm,kind", [(16, 6, "ties"), (256, 32, "uniform")])
def test_saturate_expand_scatter_exact(q, nm, kind):
    ov, og = lists((4, 5), q, nm, kind, seed=q, unfilled=2)
    ov = ov + 1.5                                     # min not yet 0
    jv, js = jl.saturate_list(jnp.asarray(ov), 0.3)
    tv, ts = tl.saturate_list(t(ov), 0.3)
    same((tv, ts), (jv, js))
    same((tl.expand_list(tv, t(og).to(torch.uint8), ts, q),),
         (jl.expand_list(jv, jnp.asarray(og, jnp.uint8), js, q),))
    # duplicated ids: the one-hot min keeps the cheaper entry
    og[..., 1] = og[..., 0]
    same((tmc.scatter_topk_dense(t(ov), t(og), q),),
         (jmc.scatter_topk_dense(jnp.asarray(ov), jnp.asarray(og), q),))


def jax_frames(n, m, q, f, ebn0, seed):
    """A JAX code and intrinsics of its all-zero codeword."""
    jc = jrandom_regular(n, m, q, seed=seed)
    sigma = sigma_for(ChannelSpec(), ebn0, jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(seed),
                        jnp.zeros((f, n), jnp.int32), q, sigma)
    return jc, np.array(intr)


LIST_CFG = dict(max_iters=10, schedule="layered", cn="ems", offset=0.3,
                loop="host", storage="compressed")


@pytest.mark.parametrize("n,m,q,nm,nboper,ebn0", [
    (96, 48, 16, 8, 64, 1.0),       # the bench's budget on a small code
    (96, 48, 16, 8, 0, 1.0),        # exact merges
    (48, 24, 64, 12, 24, 1.5),      # a staircase cut short of nm rows
])
def test_list_decode_f32_matches_jax(n, m, q, nm, nboper, ebn0):
    jc, intr = jax_frames(n, m, q, 32, ebn0, seed=n + q + nboper)
    jcfg = JConfig(nm=nm, nboper=nboper, dtype="float32", **LIST_CFG)
    want = [np.asarray(x) for x in jdecode(jc, jnp.asarray(intr), jcfg)]
    assert want[1].max() > 1 and want[2].any()        # informative
    got = decode(from_jax_code(jc), t(intr),
                 DecoderConfig(**dataclasses.asdict(jcfg)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_list_decode_bf16_decisions_match_jax():
    jc, intr = jax_frames(96, 48, 16, 48, 2.0, seed=3)
    jcfg = JConfig(nm=8, nboper=64, dtype="bfloat16", **LIST_CFG)
    jd, _, jconv = (np.asarray(x) for x in jdecode(jc, jnp.asarray(intr),
                                                   jcfg))
    d, it, conv = decode(from_jax_code(jc), t(intr),
                         DecoderConfig(**dataclasses.asdict(jcfg)))
    both = conv.numpy() & jconv
    assert both.sum() >= len(both) // 2
    np.testing.assert_array_equal(d.numpy()[both], jd[both])
    assert it.dtype == torch.int32 and 1 <= int(it.max()) <= 10


def test_list_mc_fer_ci_overlaps_jax():
    jc = jrandom_regular(96, 48, 16, seed=0)
    dec = dict(nm=8, nboper=64, dtype="bfloat16", **LIST_CFG)
    kw = dict(ebn0_db=1.5, frames_per_batch=64, max_frames=128,
              stop_errors=10**9)
    jres = JMonteCarlo(jc, JSimConfig(decoder=JConfig(**dec), **kw)).run()
    tres = MonteCarlo(from_jax_code(jc),
                      SimConfig(decoder=DecoderConfig(**dec), **kw),
                      device="cpu").run()
    assert tres.frames == jres.frames == 128
    assert 0 < tres.frame_errors < tres.frames        # an informative point
    assert overlapping(tres.frame_errors, tres.frames,
                       jres.frame_errors, jres.frames), (
        tres.fer_ci, jres.fer_ci)
    assert 1 < tres.avg_iters < 10
