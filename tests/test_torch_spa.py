"""The SPA check node and the layered SPA decoder: the port against JAX.

Inputs are made from a seeded numpy generator and fed to both packages.
Tolerances and their reasons:
* the transform tables are integer maps: exact;
* the CN (port's plain version against JAX ``fb_checknode_spa_fused``):
  atol 1e-3 on the costs of non-padding lanes, as
  ``tests/test_spa_fused.py`` holds the JAX lowerings to each other.  The
  port sums the WHT by one Hadamard product, JAX by grouped row-permuted
  ones, and exp/log differ by an ulp between the two libraries; padding
  lanes must be exactly 0 in both;
* the decoder: identical decisions, iteration counts and convergence
  flags; the state after one step (APP, CtoV) by ``assert_costs_close``:
  probabilities exp(-cost) within atol 1e-5 everywhere, and costs within
  atol 1e-3 where the JAX cost is <= 10.  The inverse transform cancels q
  terms of O(1) down to p, so f32 leaves p an absolute error near 1e-7,
  which is a cost error near 1e-7 / p: small for the likely symbols,
  up to ~1e-2 for costs past 10 (p < 5e-5), on either side.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ems_nbldpc_tpu.decoder.api import DecoderConfig as JConfig
from ems_nbldpc_tpu.decoder.api import decode as jdecode
from ems_nbldpc_tpu.decoder.graph import DeviceGraph as JGraph
from ems_nbldpc_tpu.decoder.graph import RotationPlan
from ems_nbldpc_tpu.decoder.layered import \
    make_layered_stepper as jmake_stepper
from ems_nbldpc_tpu.gf import get_gf as jget_gf
from ems_nbldpc_tpu.models.channels import ChannelSpec, bpsk_awgn, sigma_for
from ems_nbldpc_tpu.models.code import from_parsed as jfrom_parsed
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular
from ems_nbldpc_tpu.models.formats import ParsedMatrix as JParsedMatrix
from ems_nbldpc_tpu.ops import fht as jfht

from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.graph import DeviceGraph
from ems_nbldpc_torch.decoder.layered import make_layered_stepper
from ems_nbldpc_torch.gf import get_gf
from ems_nbldpc_torch.models.code import from_jax_code
from ems_nbldpc_torch.ops import cuda_spa, fht

# a hand-written irregular code: rows of degree 3, 4 and 5, columns of
# degree 1 to 3 (so the layers carry padded slots)
IRREGULAR_ROWS = [[0, 1, 2, 3], [4, 5, 6], [7, 8, 9, 10, 11],
                  [12, 13, 14, 15], [0, 4, 7, 12, 1], [2, 5, 8, 13],
                  [3, 6, 9, 14, 10], [11, 15, 1, 5]]


def irregular_code(q, seed=0):
    rng = np.random.default_rng(seed)
    rows = [np.asarray(r) for r in IRREGULAR_ROWS]
    coefs = [rng.integers(1, q, len(r)) for r in rows]
    return jfrom_parsed(JParsedMatrix(16, len(rows), q, rows, coefs),
                        name="irregular16")


def zero_word_frames(jc, f, ebn0, seed):
    """Intrinsics of the all-zero codeword through the JAX channel."""
    sigma = sigma_for(ChannelSpec(), ebn0, jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(seed),
                        jnp.zeros((f, jc.n), jnp.int32), jc.q, sigma)
    return np.array(intr)


def assert_costs_close(got, want, err_msg=""):
    np.testing.assert_allclose(np.exp(-got), np.exp(-want), rtol=0,
                               atol=1e-5, err_msg=err_msg)
    likely = want <= 10
    np.testing.assert_allclose(got[likely], want[likely], rtol=0, atol=1e-3,
                               err_msg=err_msg)


def tables(q):
    return tuple(torch.from_numpy(t)
                 for t in fht.transpose_perm_tables(get_gf(q)))


@pytest.mark.parametrize("q", [4, 16, 64, 256])
def test_transpose_perm_tables_match_jax(q):
    jgf, tgf = jget_gf(q), get_gf(q)
    t, tinv = fht.transpose_perm_tables(tgf)
    for h in range(q):
        want = jfht.mul_transpose_perm(jgf, h)
        np.testing.assert_array_equal(fht.mul_transpose_perm(tgf, h), want)
        np.testing.assert_array_equal(t[h], want)
        if h:
            np.testing.assert_array_equal(t[h][tinv[h]], np.arange(q))
    np.testing.assert_array_equal(fht.hadamard(q), jfht.hadamard(q))


def test_transforms_and_products_match_jax():
    rng = np.random.default_rng(3)
    cost = (rng.random((7, 5, 64)) * 80).astype(np.float32)   # past the clamp
    p = fht.costs_to_probs(torch.from_numpy(cost))
    jp = jfht.costs_to_probs(jnp.asarray(cost))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-30)
    np.testing.assert_allclose(
        fht.probs_to_costs(p).numpy(), np.asarray(jfht.probs_to_costs(jp)),
        atol=1e-4)
    for dc in (1, 2, 3, 5):
        w = rng.standard_normal((4, dc, 16)).astype(np.float32)
        # same association of products: bit for bit
        np.testing.assert_array_equal(
            fht._fb_products(torch.from_numpy(w)).numpy(),
            np.asarray(jfht._fb_products(jnp.asarray(w))))


@pytest.mark.parametrize("q", [16, 64, 256])
def test_plain_cn_matches_jax_fused(q):
    rng = np.random.default_rng(q)
    f, gdim, dc = 3, 5, 4
    coefs = rng.integers(1, q, size=(gdim, dc))
    coefs[1, 2] = 0                                   # one padding lane
    mvc = (rng.random((f, gdim, dc, q)) * 10).astype(np.float32)
    mvc[0, 0, 0] = 0.0                                # a flat message
    mvc -= mvc.min(axis=-1, keepdims=True)
    jgf = jget_gf(q)
    want = np.asarray(jfht.fb_checknode_spa_fused(
        jnp.asarray(mvc), RotationPlan.build(coefs, jgf), jgf))
    t_tab, tinv_tab = tables(q)
    c = torch.from_numpy(coefs.astype(np.int32))
    before = cuda_spa.launches
    got = cuda_spa.spa_checknode(torch.from_numpy(mvc).reshape(-1, dc, q), c,
                                 t_tab, tinv_tab).reshape(mvc.shape).numpy()
    assert cuda_spa.launches == before      # CPU tensors run the plain version
    valid = coefs != 0
    np.testing.assert_allclose(got[:, valid], want[:, valid], atol=1e-3)
    assert (got[:, ~valid] == 0).all() and (want[:, ~valid] == 0).all()
    assert (got.min(axis=-1) == 0).all()
    # the wrapper is the plain version with per-position tables (equal up
    # to torch's CPU exp, whose last bits can change between two calls in
    # one process)
    t_in, t_out = fht.position_tables(c, t_tab, tinv_tab)
    plain = fht.spa_checknode_plain(torch.from_numpy(mvc), t_in, t_out)
    assert_costs_close(plain.numpy(), got)


@pytest.mark.parametrize("bad", [
    "float64", "2d", "noncontig", "dc1", "q_not_pow2", "q512", "coefs_dtype",
    "coefs_width", "t_not_mult_g", "table_dtype", "table_shape", "smem"])
def test_wrapper_rejects_bad_inputs(bad):
    t, g, dc, q = 6, 3, 4, 16
    mvc = torch.zeros((t, dc, q))
    coefs = torch.ones((g, dc), dtype=torch.int32)
    t_tab, tinv_tab = tables(q)
    err = ValueError
    if bad == "float64":
        mvc, err = mvc.double(), TypeError
    elif bad == "2d":
        mvc = mvc.reshape(t * dc, q)
    elif bad == "noncontig":
        mvc = torch.zeros((dc, t, q)).transpose(0, 1)
    elif bad == "dc1":
        mvc, coefs = mvc[:, :1].contiguous(), coefs[:, :1].contiguous()
    elif bad == "q_not_pow2":
        mvc = mvc[..., :12].contiguous()
    elif bad == "q512":
        mvc = torch.zeros((t, dc, 512))
    elif bad == "coefs_dtype":
        coefs = coefs.long()
    elif bad == "coefs_width":
        coefs = coefs[:, :3].contiguous()
    elif bad == "t_not_mult_g":
        coefs = torch.ones((4, dc), dtype=torch.int32)
    elif bad == "table_dtype":
        t_tab = t_tab.long()
    elif bad == "table_shape":
        tinv_tab = tinv_tab[:8].contiguous()
    elif bad == "smem":
        mvc = torch.zeros((2, 120, 256))
        coefs = torch.ones((1, 120), dtype=torch.int32)
        t_tab, tinv_tab = tables(256)
    with pytest.raises(err):
        cuda_spa.spa_checknode(mvc, coefs, t_tab, tinv_tab)


CODES = {
    "regular": lambda: jrandom_regular(96, 48, 16, seed=1),
    "irregular": lambda: irregular_code(16),
}


@pytest.mark.parametrize("name,ebn0", [("regular", 1.0), ("irregular", 0.0)])
def test_decode_matches_jax(name, ebn0):
    jc = CODES[name]()
    intr = zero_word_frames(jc, 48, ebn0, seed=7)
    jcfg = JConfig(max_iters=12, schedule="layered", cn="spa", nm=0,
                   loop="host", storage="dense", dtype="float32")
    want = [np.asarray(x) for x in jdecode(jc, jnp.asarray(intr), jcfg)]
    # informative: some frames need several iterations, some converge
    assert want[1].max() > 1 and want[2].any()
    got = decode(from_jax_code(jc), torch.from_numpy(intr),
                 DecoderConfig(**dataclasses.asdict(jcfg)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("name", ["regular", "irregular"])
def test_state_after_one_step_matches_jax(name):
    jc = CODES[name]()
    intr = zero_word_frames(jc, 16, 0.5, seed=9)
    jinit, jstep = jmake_stepper(JGraph.from_code(jc), 0, 0.0, "spa")
    jstate = jstep(jinit(jnp.asarray(intr)))
    g = DeviceGraph.from_code(from_jax_code(jc))
    init, step = make_layered_stepper(g, 0, 0.0, "spa")
    tstate = step(init(torch.from_numpy(intr)))
    for name_, a, b in zip(("app", "ctov", "decide", "conv", "iters"),
                           tstate, jstate):
        b = np.asarray(b)
        if name_ in ("app", "ctov"):
            assert_costs_close(a.numpy(), b, err_msg=name_)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name_)


def test_plain_spa_argument_runs_the_same_decode():
    """``plain`` (the card's comparison path) is the CPU path: the same
    decisions, and the same state up to ``assert_costs_close``."""
    jc = CODES["irregular"]()
    intr = torch.from_numpy(zero_word_frames(jc, 8, 0.0, seed=11))
    g = DeviceGraph.from_code(from_jax_code(jc))
    states = []
    for plain in (False, True):
        init, step = make_layered_stepper(g, 0, 0.0, "spa", plain=plain)
        states.append(step(step(init(intr.clone()))))
    for i, (a, b) in enumerate(zip(*states)):
        if i < 2:                                   # app, ctov
            assert_costs_close(a.numpy(), b.numpy())
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version at small shapes (card only;
    chip_smoke.py runs the full-size comparison)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    for t, g, dc, q in [(300, 30, 4, 256), (100, 10, 3, 16), (40, 8, 7, 64)]:
        coefs = rng.integers(0, q, (g, dc)).astype(np.int32)
        mvc = torch.from_numpy(
            (rng.random((t, dc, q)) * 30).astype(np.float32)).cuda()
        t_tab, tinv_tab = (x.cuda() for x in tables(q))
        c = torch.from_numpy(coefs).cuda()
        before = cuda_spa.launches
        got = cuda_spa.spa_checknode(mvc, c, t_tab, tinv_tab)
        assert cuda_spa.launches == before + 1
        t_in, t_out = fht.position_tables(c, t_tab, tinv_tab)
        want = fht.spa_checknode_plain(mvc.reshape(t // g, g, dc, q), t_in,
                                       t_out).reshape(t, dc, q)
        torch.testing.assert_close(torch.exp(-got), torch.exp(-want),
                                   rtol=0, atol=1e-5)
