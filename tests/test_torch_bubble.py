"""Exact bubble emulation (``cn_impl="bubble"`` / ``"lbubble"``): the port
against the JAX package.

Every code and GF table is built here (``random_regular`` and the
irregular codes of ``tests/test_torch_flooding.py``), never read from the
registry, and JAX's bubble functions are called directly.

* ``golden.py``, the port's NumPy copy, against JAX's golden model:
  identical outputs (the same NumPy float64 operations in the same order).
* ``ops/bubble_cn``'s ops against JAX's on the same f32 inputs: bit for
  bit (``view(int32)`` equality); against the golden copy in f64: ids
  equal, values within 1e-5 (f32 against f64 sums of values <= ~30).
* The whole CN step on unrotated rows (``cuda_bubble.bubble_rows``; on a
  CPU tensor its plain version) against JAX's layered and flooding routes
  composed of JAX's own ops: bit for bit.
* Decodes against JAX's ``decode``: identical decisions, iteration counts
  and convergence flags.

The JAX side compiles every elementary step's loop (its check node is
jitted once per shape); the file takes about 90 s alone, most of it the
JAX decodes' compiles.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ems_nbldpc_tpu import golden as jgolden
from ems_nbldpc_tpu.decoder.api import DecoderConfig as JConfig
from ems_nbldpc_tpu.decoder.api import decode as jdecode
from ems_nbldpc_tpu.gf import get_gf as jget_gf
from ems_nbldpc_tpu.models.channels import ChannelSpec, bpsk_awgn, sigma_for
from ems_nbldpc_tpu.models.code import from_parsed as jfrom_parsed
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular
from ems_nbldpc_tpu.models.formats import ParsedMatrix as JParsedMatrix
from ems_nbldpc_tpu.ops import bubble_cn as jbubble
from ems_nbldpc_tpu.ops import minconv as jminconv

from ems_nbldpc_torch import golden
from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.graph import rotation_table
from ems_nbldpc_torch.gf import get_gf
from ems_nbldpc_torch.models.code import from_jax_code, random_regular
from ems_nbldpc_torch.ops import bubble_cn, cuda_bubble


def sorted_lists(rng, rows, q, nm, kind):
    """[rows, nm] f32 (values, ids) as the CN hands them to an elementary
    step: the nm best of a dense message, lower id first among ties, minus
    the first value.  "ties": integer levels 0..2, so equal values inside
    the lists and at their edge; "tails": an earlier merge's output, whose
    last entries are unfilled (BIG, -1)."""
    d = rng.random((rows, q)).astype(np.float32) * 9
    if kind == "ties":
        d = np.floor(d / 3).astype(np.float32)
    ids = np.argsort(d, axis=1, kind="stable")[:, :nm].astype(np.int32)
    vals = np.take_along_axis(d, ids, 1)
    vals = vals - vals[:, :1]
    if kind == "tails":
        filled = rng.integers(1, nm + 1, (rows, 1))
        tail = np.arange(nm) >= filled
        vals[tail], ids[tail] = np.float32(jbubble.BIG), -1
    return vals, ids


def elementary_inputs(q, nm, seed):
    """Uniform, ties and tails list pairs, stacked (a tail in either
    list)."""
    rng = np.random.default_rng(seed)
    pairs = [sorted_lists(rng, 12, q, nm, k1) + sorted_lists(rng, 12, q, nm,
                                                             k2)
             for k1, k2 in (("uniform", "uniform"), ("ties", "ties"),
                            ("tails", "uniform"), ("uniform", "tails"))]
    return [np.concatenate(a) for a in zip(*pairs)]


ELEMENTARY = [  # q, nm, nb_oper
    (64, 8, 12), (64, 12, 24), (64, 16, 30), (256, 32, 64),
    (16, 12, 5),                 # nb_oper < nm: unfilled tails
    (256, 16, 9),
    (16, 16, 40),                # nm = q
    (16, 3, 9),                  # nm below the 8-bubble's seeds
]


@pytest.mark.parametrize("variant", ["8", "L"])
@pytest.mark.parametrize("q,nm,nb_oper", ELEMENTARY)
def test_elementary_matches_jax_and_golden(q, nm, nb_oper, variant):
    v1, g1, v2, g2 = elementary_inputs(q, nm, seed=q + nm + nb_oper)
    want_v, want_g = (np.asarray(a) for a in jbubble.elementary_bubble_batch(
        *map(jnp.asarray, (v1, g1, v2, g2)), nm, nb_oper, q, variant))
    got_v, got_g = bubble_cn.elementary_bubble_batch(
        *map(torch.from_numpy, (v1, g1, v2, g2)), nm, nb_oper, q, variant)
    # bit for bit against JAX (f32)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  want_v.view(np.int32))
    # against the golden copy (f64): ids equal, values within 1e-5
    ref = (golden.elementary_bubble if variant == "8"
           else golden.elementary_lbubble)
    for r in range(len(v1)):
        gv, gg = ref(v1[r].astype(np.float64), g1[r], v2[r].astype(np.float64),
                     g2[r], nm, nb_oper)
        np.testing.assert_array_equal(got_g[r].numpy(), gg, err_msg=str(r))
        np.testing.assert_allclose(got_v[r].numpy(), gv, rtol=0, atol=1e-5,
                                   err_msg=str(r))


@pytest.mark.parametrize("q,nm", [(16, 8), (64, 12), (256, 32)])
def test_golden_copy_matches_jax_golden(q, nm):
    """sort_truncate, both elementary steps and check_pass_ems of the
    port's golden copy equal JAX's golden model exactly."""
    rng = np.random.default_rng(q)
    gf, jgf = get_gf(q), jget_gf(q)
    np.testing.assert_array_equal(gf.mul_table, jgf.mul_table)
    for trial in range(6):
        dense = rng.random((5, q)) * 9
        if trial % 2:
            dense = np.floor(dense / 3)
        lists = [golden.sort_truncate(d, nm) for d in dense]
        for (v, g), d in zip(lists, dense):
            jv, jg = jgolden.sort_truncate(d, nm)
            np.testing.assert_array_equal(v, jv)
            np.testing.assert_array_equal(g, jg)
        (v1, g1), (v2, g2) = lists[:2]
        for nb_oper in (nm // 2, 2 * nm):
            for ours, theirs in (
                    (golden.elementary_bubble(v1, g1, v2, g2, nm, nb_oper),
                     jgolden.elementary_bubble(v1, g1, v2, g2, nm, nb_oper)),
                    (golden.elementary_lbubble(v1, g1, v2, g2, nm, nb_oper),
                     jgolden.elementary_lbubble(v1, g1, v2, g2, nm,
                                                nb_oper))):
                for a, b in zip(ours, theirs):
                    np.testing.assert_array_equal(a, b)
        coefs = rng.integers(1, q, 5)
        for variant in ("8", "L"):
            got = golden.check_pass_ems(
                [x[0] for x in lists], [x[1] for x in lists], coefs,
                gf.mul_table, golden._div_table(gf), nm, 2 * nm, 0.3, q,
                bubble=variant)
            want = jgolden.check_pass_ems(
                [x[0] for x in lists], [x[1] for x in lists], coefs,
                jgf.mul_table, jgolden._div_table(jgf), nm, 2 * nm, 0.3, q,
                bubble=variant)
            np.testing.assert_array_equal(got, want)


def test_golden_decode_matches_jax_golden():
    """decode_layered_golden of the copy equals JAX's on noisy frames."""
    jc = jrandom_regular(48, 24, 64, seed=1)
    code = from_jax_code(jc)
    sigma = sigma_for(ChannelSpec(), 1.5, jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(2),
                        jnp.zeros((4, jc.n), jnp.int32), 64, sigma)
    intr = np.asarray(intr, np.float64)
    for f in range(len(intr)):
        for variant in ("8", "L"):
            got = golden.decode_layered_golden(code, intr[f], 6, 12, 0.3, 24,
                                               bubble=variant)
            want = jgolden.decode_layered_golden(jc, intr[f], 6, 12, 0.3, 24,
                                                 bubble=variant)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:], (f, variant)


def row_tables(g, dc, q, seed, pad):
    """uint8 rotation tables [G, dc, q] and valid [G, dc] for random
    coefficients, with a few padding slots (coefficient 0) when ``pad``."""
    rng = np.random.default_rng(seed)
    coefs = rng.integers(1, q, (g, dc))
    if pad:
        coefs[0, -1] = 0
        coefs[rng.integers(0, g, 2), rng.integers(0, dc, 2)] = 0
    tabs = [rotation_table(coefs, get_gf(q), d).reshape(g, dc, q)
            .astype(np.uint8) for d in ("in", "out")]
    return tabs[0], tabs[1], coefs != 0


# one compile per shape and settings, shared by both schedules' routes and
# the bare check
jax_checknode = jax.jit(jbubble.fb_checknode_bubble,
                        static_argnums=(1, 2, 3, 4))


def jax_route(x, rin, rout, valid, nm, nb_oper, offset, variant, layered):
    """JAX's bubble CN step on rows, composed of its own ops in the order
    of its call sites (``layered.py:120-200`` / ``flooding.py:105-158``):
    truncate, rotate in, delta on padded slots, fb_checknode_bubble,
    rotate out, (layered) ems_output_saturate, normalise."""
    t, dc, q = x.shape
    g = rin.shape[0]
    v = jnp.asarray(x).reshape(t // g, g, dc, q)
    if nm < q:
        v = jminconv.ems_input_truncate(v, nm)
    v = jnp.take_along_axis(v, jnp.broadcast_to(rin.astype(np.int32), v.shape),
                            -1)
    v = jnp.where(valid[None, ..., None], v,
                  jminconv.delta_message(v.shape[:-1], q, v.dtype))
    out = jax_checknode(v, nm, nb_oper, offset, variant)
    out = jnp.take_along_axis(
        out, jnp.broadcast_to(rout.astype(np.int32), out.shape), -1)
    if layered and nm < q:
        out = jminconv.ems_output_saturate(out, nm, offset)
    out = out - jnp.min(out, axis=-1, keepdims=True)
    return np.asarray(out).reshape(t, dc, q)


@pytest.mark.parametrize("dc,q,nm,pad,variant,kind", [
    (3, 16, 8, True, "8", "uniform"),
    (4, 256, 32, False, "L", "ties"),
    (5, 16, 16, True, "L", "uniform"),     # nm = q: no truncation
    (6, 64, 12, True, "8", "ties"),
])
@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_checknode_matches_jax_routes(dc, q, nm, pad, variant, kind,
                                      schedule):
    """``fb_checknode_bubble`` on JAX's rotated rows, and the whole step
    (``bubble_rows`` on CPU tensors, its plain version) on unrotated rows,
    equal JAX's bit for bit; padded slots included (the delta message has
    INF = 1e9 entries, whose sums with the BIG = 1e5 sentinels must round
    alike)."""
    rng = np.random.default_rng(dc * q + nm)
    t, g, nb_oper, offset = 12, 3, 2 * nm - 3, 0.3
    x = rng.random((t, dc, q)).astype(np.float32) * 9
    if kind == "ties":
        x = np.floor(x / 3).astype(np.float32)
    x -= x.min(axis=-1, keepdims=True)
    rin, rout, valid = row_tables(g, dc, q, seed=dc, pad=pad)
    layered = schedule == "layered"
    want = jax_route(x, rin, rout, valid, nm, nb_oper, offset, variant,
                     layered)
    got = cuda_bubble.bubble_rows(
        torch.from_numpy(x), torch.from_numpy(rin), torch.from_numpy(rout),
        torch.from_numpy(valid) if pad else None, nm, nb_oper, offset,
        nm < q, layered and nm < q, variant)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # the bare CN on rotated rows
    vr = np.take_along_axis(x, np.tile(rin, (t // g, 1, 1)), -1)
    vr[np.tile(~valid, (t // g, 1))] = np.where(np.arange(q) == 0, 0.0, 1e9)
    jout = np.asarray(jax_checknode(jnp.asarray(vr), nm, nb_oper, offset,
                                    variant))
    tout = bubble_cn.fb_checknode_bubble(torch.from_numpy(vr), nm, nb_oper,
                                         offset, variant)
    np.testing.assert_array_equal(tout.numpy().view(np.int32),
                                  jout.view(np.int32))
    # saturation on top of the bubble CN's fill changes nothing (offset
    # >= 0), which lets the kernel skip it
    assert torch.equal(
        bubble_cn.bubble_rows_plain(
            torch.from_numpy(x), torch.from_numpy(rin),
            torch.from_numpy(rout), torch.from_numpy(valid), nm, nb_oper,
            offset, nm < q, True, variant),
        bubble_cn.bubble_rows_plain(
            torch.from_numpy(x), torch.from_numpy(rin),
            torch.from_numpy(rout), torch.from_numpy(valid), nm, nb_oper,
            offset, nm < q, False, variant))


def tiny_irregular():
    """The hand-built GF(16) code of ``tests/test_torch_flooding.py``: rows
    of degree 3 and 2, so padded row slots."""
    rows = [np.array([0, 1, 2]), np.array([1, 3]), np.array([0, 3, 4]),
            np.array([2, 4])]
    coefs = [np.array([1, 3, 7]), np.array([2, 5]), np.array([4, 9, 1]),
             np.array([6, 8])]
    return jfrom_parsed(JParsedMatrix(5, 4, 16, rows, coefs),
                        name="tiny_irr")


def irregular16():
    """Rows of degree 3, 4 and 5 and columns of degree 1 to 3 (the code of
    ``tests/test_torch_flooding.py``), so padded row and column slots."""
    rows = [[0, 1, 2, 3], [4, 5, 6], [7, 8, 9, 10, 11], [12, 13, 14, 15],
            [0, 4, 7, 12, 1], [2, 5, 8, 13], [3, 6, 9, 14, 10],
            [11, 15, 1, 5]]
    rng = np.random.default_rng(0)
    coefs = [rng.integers(1, 16, len(r)) for r in rows]
    return jfrom_parsed(JParsedMatrix(16, len(rows), 16,
                                      [np.asarray(r) for r in rows], coefs),
                        name="irregular16")


def noisy(jc, frames, ebn0, seed):
    sigma = sigma_for(ChannelSpec(), ebn0, jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(seed),
                        jnp.zeros((frames, jc.n), jnp.int32), jc.q, sigma)
    return np.array(intr)


@pytest.mark.parametrize("code,schedule,cn_impl,cn,nm,ebn0", [
    (tiny_irregular, "layered", "bubble", "minsum", 5, 0.5),
    (irregular16, "flooding", "lbubble", "ems", 6, 1.0),
    (tiny_irregular, "layered", "lbubble", "ems", 4, 0.5),
    (irregular16, "flooding", "bubble", "minsum", 8, 1.0),
])
def test_irregular_decode_matches_jax(code, schedule, cn_impl, cn, nm, ebn0):
    """Whole bubble decodes on irregular codes (padded row and column
    slots), under both loops of the port, against JAX's ``decode``:
    identical decisions, iterations and convergence."""
    jc = code()
    intr = noisy(jc, 12, ebn0, seed=jc.n)
    jcfg = JConfig(max_iters=8, schedule=schedule, cn=cn, nm=nm, offset=0.3,
                   cn_impl=cn_impl, nboper=2 * nm - 2, loop="host")
    want = [np.asarray(x) for x in jdecode(jc, jnp.asarray(intr), jcfg)]
    assert want[1].max() > 1, "uninformative batch"
    for loop in ("host", "device"):
        got = decode(from_jax_code(jc), torch.from_numpy(intr),
                     DecoderConfig(**dict(dataclasses.asdict(jcfg),
                                          loop=loop)))
        for name, a, b in zip(("decide", "iters", "conv"), got, want):
            np.testing.assert_array_equal(a.numpy(), b,
                                          err_msg=f"{name} {loop}")


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
@pytest.mark.parametrize("change,what", [
    (dict(nm=0), "nm"), (dict(nm=17), "nm"), (dict(code="dc2"), "degree"),
])
def test_bubble_guards(schedule, change, what):
    """nm = 0 (JAX's ``top_k(v, 0)`` breaks), nm > q and rows of degree 2
    raise ``ValueError`` before any step, on both schedules."""
    code = (random_regular(12, 12, 16, dv=2, seed=0)
            if change.get("code") == "dc2"
            else random_regular(24, 12, 16, seed=2))
    cfg = DecoderConfig(max_iters=2, schedule=schedule, cn="ems",
                        nm=change.get("nm", 4), cn_impl="bubble",
                        loop="host")
    with pytest.raises(ValueError, match=what):
        decode(code, torch.zeros((2, code.n, code.q)), cfg)
