"""The decoder configurations that reach a hand kernel on the card: K1's
dense min-convolution mode, its rows of dc <= 2 and its routes under
``cn_impl`` auto / topk / dense, and K3's exact mode and general step (the
exact list merge, nm > 64, the workspace), against the JAX package and
the port's torch routes.

On a CPU tensor each wrapper runs its plain version, so these tests hold
the plain versions the kernels are held to on the card (chip_smoke.py 3,
3g, 5f, 5l, 4j) and the route each configuration takes.  Tolerance: none.
Every step of the dense min-convolution is a selection, a gather, an
exact minimum or one f32 add, so ``ems_rows_plain(..., dense=True)`` equals
JAX's ``fb_checknode_dense`` composition and the port's torch routes bit
for bit; decodes give the same decisions, iterations and convergence.
Inputs are made from seeded numpy generators; "ties" inputs draw from a
few integer levels, so that more than nm entries tie the nm-th.  Sizes are
small (q <= 64, a few frames), and the JAX decodes few: the file takes
well under a minute.
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
from ems_nbldpc_tpu.gf import get_gf as jget_gf
from ems_nbldpc_tpu.models.channels import ChannelSpec, bpsk_awgn, sigma_for
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular
from ems_nbldpc_tpu.ops import minconv as jmc

from ems_nbldpc_torch.decoder import flooding, layered
from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.graph import DeviceGraph, rotation_table
from ems_nbldpc_torch.models.code import from_jax_code, random_regular
from ems_nbldpc_torch.ops import cuda_cn, cuda_list
from ems_nbldpc_torch.ops.minconv import ems_output_saturate

OFFSET = 0.3


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: under the tier-1 run's workers, torch's
    per-core threads on these small tensors cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rows(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        v = rng.integers(0, 6, shape).astype(np.float32)
    else:
        v = (rng.random(shape) * 9).astype(np.float32)
    return v - v.min(axis=-1, keepdims=True)


def coef_tables(g, dc, q, padding, seed):
    """[G, dc] coefficients (0 at a few slots with ``padding``)."""
    rng = np.random.default_rng(seed)
    coefs = rng.integers(1, q, (g, dc))
    if padding:
        coefs[0, -1] = 0
        coefs[rng.integers(0, g, 3), rng.integers(0, dc, 3)] = 0
    return coefs


def jax_dense(x, t_in, t_out, valid, nm, truncate):
    """JAX's dense route on [F, G, dc, q] rows: truncate, rotate, mask and
    ``fb_checknode_dense``, rotate back, saturate, normalise."""
    v = np.asarray(jmc.ems_input_truncate(jnp.asarray(x), nm)) if truncate \
        else x
    vr = np.take_along_axis(v, np.broadcast_to(t_in, v.shape), -1)
    out = np.asarray(jmc.fb_checknode_dense(
        jnp.asarray(vr), None if valid is None else jnp.asarray(valid)))
    out = np.take_along_axis(out, np.broadcast_to(t_out, out.shape), -1)
    if truncate:
        out = np.asarray(jmc.ems_output_saturate(jnp.asarray(out), nm,
                                                 OFFSET))
    return out - out.min(axis=-1, keepdims=True)


@pytest.mark.parametrize("q,dc,nm,truncate,kind,padding", [
    (16, 3, 6, True, "ties", True), (16, 4, 12, True, "ties", True),
    (16, 5, 9, True, "uniform", False), (16, 4, 16, False, "uniform", True),
    (64, 4, 40, True, "ties", True), (64, 3, 64, False, "ties", False),
    (16, 2, 6, True, "ties", True), (16, 1, 6, True, "uniform", False)])
def test_dense_mode_matches_jax_composition(q, dc, nm, truncate, kind,
                                            padding):
    """``ems_rows(..., dense=True)`` (on a CPU tensor its plain version)
    equals JAX's dense composition; with truncation on "ties" rows more
    than nm entries tie the nm-th, and all of them stay.  Rows of dc = 2
    swap their inputs and rows of dc = 1 give the delta message, with the
    steps around the check node as for any row."""
    f, g = 3, 5
    x = rows((f, g, dc, q), kind, seed=q + dc + nm)
    coefs = coef_tables(g, dc, q, padding, seed=dc)
    valid = coefs != 0 if padding else None
    rin, rout = (rotation_table(coefs, jget_gf(q), d).reshape(g, dc, q)
                 for d in ("in", "out"))
    want = jax_dense(x, rin, rout, valid, nm, truncate)
    got = cuda_cn.ems_rows(
        torch.from_numpy(x.reshape(f * g, dc, q)),
        torch.from_numpy(rin.astype(np.uint8)),
        torch.from_numpy(rout.astype(np.uint8)),
        None if valid is None else torch.from_numpy(valid), nm, OFFSET,
        truncate, dense=True)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    if truncate and kind == "ties":
        kth = np.sort(x, -1)[..., nm - 1:nm]
        assert ((x <= kth).sum(-1) > nm).any()


def tiny_irregular():
    """Rows of degree 3 and 2 over GF(16): padded row slots."""
    from ems_nbldpc_tpu.models.code import from_parsed as jfrom_parsed
    from ems_nbldpc_tpu.models.formats import ParsedMatrix as JParsedMatrix
    rows_ = [np.array([0, 1, 2]), np.array([1, 3]), np.array([0, 3, 4]),
             np.array([2, 4])]
    coefs = [np.array([1, 3, 7]), np.array([2, 5]), np.array([4, 9, 1]),
             np.array([6, 8])]
    return from_jax_code(jfrom_parsed(JParsedMatrix(5, 4, 16, rows_, coefs),
                                      name="tiny_irr"))


def code_of(kind):
    if kind == "degree2":
        return random_regular(24, 24, 16, seed=1)
    return (random_regular(48, 24, 16, seed=3) if kind == "regular"
            else tiny_irregular())


DENSE = [("ems", 12, "auto"), ("ems", 6, "dense"), ("minsum", 0, "auto"),
         ("ems", 0, "dense")]


@pytest.mark.parametrize("code", ["regular", "irregular"])
@pytest.mark.parametrize("cn,nm,cn_impl", DENSE)
def test_dense_mode_matches_layered_route(code, cn, nm, cn_impl):
    """K1's arguments for the layered dense route (``k1_route``: lists of
    all q, truncation at nm where EMS truncates) give, through
    ``ems_rows_plain``, the torch route's output: ``fb_checknode_dense``,
    saturation, normalisation, padded slots masked."""
    c = code_of(code)
    g = DeviceGraph.from_code(c)
    route = flooding.k1_route(cn, nm, c.q, cn_impl)
    assert route is not None and route[2]                 # dense
    rotated_cn = layered._make_rotated_cn(g, nm, cn, cn_impl)
    truncate = flooding.truncates(cn, nm, c.q)
    assert route[1] == truncate
    for i, p in enumerate(layered._layer_plan(g, "cpu")):
        gdim, dc = p["shape"]
        mvc = torch.from_numpy(rows((4, gdim, dc, c.q), "ties", seed=i))
        want = rotated_cn(mvc, p)
        if truncate:
            want = ems_output_saturate(want, nm, OFFSET)
        want = want - want.min(dim=-1, keepdim=True).values
        got = cuda_cn.ems_rows_plain(mvc.reshape(-1, dc, c.q), p["rot_in8"],
                                     p["rot_out8"], p["valid"], route[0],
                                     OFFSET, route[1], route[2])
        assert torch.equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("code", ["regular", "irregular", "degree2"])
@pytest.mark.parametrize("cn,nm,cn_impl", DENSE + [("ems", 5, "topk"),
                                                   ("ems", 5, "auto")])
def test_k1_route_matches_flooding_torch_route(code, cn, nm, cn_impl):
    """The flooding step through K1 (``ems_rows`` on the rows: its plain
    version here) equals its torch route (``plain``: per-edge rotations,
    delta padding edge, ``fb_checknode_topk`` or ``fb_checknode_dense``),
    on rows of dc = 2 too."""
    c = code_of(code)
    g = DeviceGraph.from_code(c)
    vtoc = torch.from_numpy(rows((6, c.n_edges, c.q), "ties", seed=nm))
    want = flooding.checknode(g, vtoc, nm, OFFSET, cn, cn_impl, plain=True)
    got = flooding.checknode(g, vtoc, nm, OFFSET, cn, cn_impl)
    assert torch.equal(got, want)


def counting(monkeypatch, module, names, calls):
    for name in names:
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)


def intrinsic(g, f, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((f, g.code.n, g.q)) * 5).astype(np.float32)
    return torch.from_numpy(x - x.min(-1, keepdims=True))


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
@pytest.mark.parametrize("cn,nm,cn_impl,dense", [
    ("ems", 8, "auto", False), ("ems", 12, "auto", True),
    ("ems", 5, "topk", False), ("ems", 6, "dense", True),
    ("minsum", 0, "auto", True), ("minsum", 4, "topk", False),
    ("ems", 8, "list", False)])
def test_route_is_k1_where_it_takes_the_rows(monkeypatch, schedule, cn, nm,
                                             cn_impl, dense):
    """One ``ems_rows`` call a super-layer (layered) or a step (flooding)
    for every EMS / min-sum ``cn_impl`` but the bubbles where K1 takes the
    rows, with lists of all q for the dense min-convolution; no torch F/B
    CN runs.  ``plain`` runs the torch CN and no ``ems_rows``.  The route
    does not depend on the device or the rows' shape: ``k1_route`` reads
    the configuration alone."""
    g = DeviceGraph.from_code(random_regular(48, 24, 16, seed=3))
    module = layered if schedule == "layered" else flooding
    route = flooding.k1_route(cn, nm, g.q, cn_impl)
    assert route is not None and route[2] == dense
    assert route[0] == (nm if flooding.truncates(cn, nm, g.q) or not dense
                        else g.q)
    make = (layered.make_layered_stepper if schedule == "layered"
            else flooding.make_flooding_stepper)
    per_step = len(g.layers) if schedule == "layered" else 1
    for plain in (False, True):
        calls = {}
        counting(monkeypatch, module, ["ems_rows", "fb_checknode_topk",
                                       "fb_checknode_dense"], calls)
        init, step = make(g, nm, OFFSET, cn, cn_impl, plain=plain)
        step(init(intrinsic(g, 2, seed=1)))
        torch_cn = "fb_checknode_dense" if dense else "fb_checknode_topk"
        assert calls == ({torch_cn: per_step} if plain
                         else {"ems_rows": per_step}), (plain, calls)
        monkeypatch.undo()


def test_compressed_topk_runs_the_bare_kernel(monkeypatch):
    """The compressed dense-CN decoder (``cn_impl="topk"``) runs K1's bare
    entry once a super-layer, on a state of either dtype, and no torch
    F/B CN."""
    g = DeviceGraph.from_code(random_regular(48, 24, 16, seed=3))
    for dtype in (torch.float32, torch.bfloat16):
        calls = {}
        counting(monkeypatch, cuda_cn, ["fb_checknode"], calls)
        counting(monkeypatch, layered, ["fb_checknode_topk",
                                        "fb_checknode_dense"], calls)
        init, step = layered.make_layered_compressed_stepper(g, 6, OFFSET,
                                                             dtype)
        step(init(intrinsic(g, 2, seed=2).to(dtype)))
        assert calls == {"fb_checknode": len(g.layers)}
        monkeypatch.undo()


def test_rows_of_degree_two_run_k1(monkeypatch):
    """Rows of dc <= 2 (a swap, no min-convolution) and rows past a
    block's shared memory (K1's workspace) take K1 like any other under
    every EMS / min-sum ``cn_impl`` but the bubbles: ``k1_route`` reads no
    shape, and the layered step calls ``ems_rows`` once a super-layer."""
    g = DeviceGraph.from_code(random_regular(24, 24, 16, seed=1))
    assert g.code.dc_max == 2
    for cn_impl in ("auto", "topk", "dense", "pallas"):
        calls = {}
        counting(monkeypatch, layered, ["ems_rows", "fb_checknode_topk",
                                        "fb_checknode_dense"], calls)
        init, step = layered.make_layered_stepper(g, 8, OFFSET, "ems",
                                                  cn_impl)
        step(init(intrinsic(g, 2, seed=3)))
        assert calls == {"ems_rows": len(g.layers)}, (cn_impl, calls)
        monkeypatch.undo()
    assert flooding.k1_route("ems", 8, 16, "pallas") == (8, True, False)
    assert flooding.k1_route("ems", 0, 256, "auto") == (256, False, True)
    assert flooding.k1_route("ems", 32, 256, "topk") == (32, True, False)
    assert flooding.k1_route("ems", 200, 256, "auto") == (200, True, True)
    assert flooding.k1_route("ems", 64, 256, "auto") == (64, True, False)
    assert flooding.k1_route("minsum", 8, 16, "auto") == (16, False, True)
    assert flooding.k1_route("ems", 8, 16, "auto", plain=True) is None
    assert flooding.k1_route("spa", 0, 256, "auto") is None
    assert flooding.k1_route("ems", 8, 16, "bubble") is None


@pytest.mark.parametrize("dc,q,nm,ok", [
    (4, 256, 32, True), (4, 256, 256, True), (120, 256, 64, True),
    (1, 2, 2, True), (4, 48, 8, False), (4, 16, 17, False),
    (4, 16, 0, False), (0, 16, 8, False)])
def test_list_limits_are_the_plain_versions(dc, q, nm, ok):
    """K3 takes every list CN the plain version takes, for every nboper
    (the exact mode, nm > 64 and rows past shared memory included), and
    its refusals name neither nboper nor a list length of 64."""
    err = cuda_list.limits_error(dc, q, nm)
    assert cuda_list.takes(dc, q, nm) == ok == (err is None)
    if not ok:
        assert "nboper" not in err and "64" not in err


# ---- decodes against JAX on the CPU ----

@functools.lru_cache(maxsize=None)
def jax_frames(n, m, q, f, ebn0, seed):
    """A JAX code and intrinsics of its all-zero codeword."""
    jc = jrandom_regular(n, m, q, seed=seed)
    sigma = sigma_for(ChannelSpec(), ebn0, jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(seed),
                        jnp.zeros((f, n), jnp.int32), q, sigma)
    return jc, np.array(intr)


@pytest.mark.parametrize("schedule,cn,nm,cn_impl,storage,nboper", [
    ("layered", "ems", 12, "auto", "dense", 0),     # dense, truncated
    ("layered", "minsum", 0, "auto", "dense", 0),   # dense, exact min-sum
    ("flooding", "ems", 6, "dense", "dense", 0),
    ("layered", "ems", 6, "topk", "compressed", 0),  # K1's bare entry
    ("layered", "ems", 16, "auto", "compressed", 0),  # K3, nm = q, exact
])
def test_decode_matches_jax(schedule, cn, nm, cn_impl, storage, nboper):
    """Each changed route's decode (host loop) on the CPU against JAX's
    on the same intrinsics: identical decisions, iterations and
    convergence."""
    jc, intr = jax_frames(48, 24, 16, 16, 1.0, seed=7)
    jcfg = JConfig(max_iters=8, schedule=schedule, cn=cn, nm=nm,
                   offset=OFFSET, cn_impl=cn_impl, storage=storage,
                   nboper=nboper, loop="host", dtype="float32")
    want = [np.asarray(x) for x in jdecode(jc, jnp.asarray(intr), jcfg)]
    assert want[1].max() > 1                              # informative
    got = decode(from_jax_code(jc), torch.from_numpy(intr),
                 DecoderConfig(**dataclasses.asdict(jcfg)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
