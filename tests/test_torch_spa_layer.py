"""The fused layered SPA super-layer step ``cuda_spa.spa_layer``: against
the torch composition it replaces, and through the decoder against the
JAX package.

On a CPU tensor ``spa_layer`` runs its plain version ``spa_layer_plain``.
Inputs are made from seeded numpy generators.  Tolerances and their
reasons:
* against the sweep as it ran before the fused kernel, rebuilt here from
  the port's plain ops (gathers, VN extrinsic minus its min,
  ``fht.spa_checknode_plain``, the output minus its min, two
  ``torch.where`` for the freeze, scatters): frozen frames, the columns
  and edges the layer does not own and the padding column and edge must
  be equal bit for bit (neither side may write them); the updated CtoV and
  APP by ``assert_costs_close`` (exp(-cost) within atol 1e-5 everywhere,
  costs within atol 1e-3 where the reference cost is <= 10).  Both sides
  run the same ops, but torch's CPU ``exp`` is not repeatable within a
  process (ROADMAP Queue 3), so they are not compared bit for bit;
* the decoder through the new route against the JAX package
  (``decode`` and ``make_layered_stepper`` with ``cn="spa"``): identical
  decisions, iteration counts and convergence flags, and the state after
  one step by ``assert_costs_close``, whose f32 reasons
  ``tests/test_torch_spa.py`` states.
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
from ems_nbldpc_tpu.decoder.layered import \
    make_layered_stepper as jmake_stepper
from ems_nbldpc_tpu.models.channels import ChannelSpec, bpsk_awgn, sigma_for
from ems_nbldpc_tpu.models.code import from_parsed as jfrom_parsed
from ems_nbldpc_tpu.models.formats import ParsedMatrix as JParsedMatrix

from ems_nbldpc_torch.decoder import layered
from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.graph import DeviceGraph
from ems_nbldpc_torch.gf import get_gf
from ems_nbldpc_torch.models.code import (from_jax_code, from_parsed,
                                          random_regular)
from ems_nbldpc_torch.models.formats import ParsedMatrix
from ems_nbldpc_torch.ops import cuda_spa, fht


def assert_costs_close(got, want, err_msg=""):
    np.testing.assert_allclose(np.exp(-got), np.exp(-want), rtol=0,
                               atol=1e-5, err_msg=err_msg)
    likely = want <= 10
    np.testing.assert_allclose(got[likely], want[likely], rtol=0, atol=1e-3,
                               err_msg=err_msg)


def irregular_rows(n, m, dc, seed):
    """m rows over n columns with degrees 2..dc (the first of degree dc)."""
    rng = np.random.default_rng(seed)
    degs = [dc] + list(rng.integers(2, dc + 1, m - 1))
    return [np.sort(rng.choice(n, d, replace=False)) for d in degs]


def make_code(kind, q, dc, seed=0):
    """A regular code (dv = 2) of row degree dc, or an irregular one of row
    degrees 2..dc, whose layers carry padded slots."""
    if kind == "regular":
        return random_regular(4 * dc, 8, q, dv=2, seed=seed)
    rows = irregular_rows(16, 8, dc, seed)
    rng = np.random.default_rng(seed + 1)
    coefs = [rng.integers(1, q, len(r)) for r in rows]
    return from_parsed(ParsedMatrix(16, len(rows), q, rows, coefs))


def layer_state(g, plan, f, seed):
    """A decoder-like state (APP [F, N+1, q], CtoV [F, E+1, q]; CtoV 0..10,
    APP = X + CtoV on the layer's slots with X one low-cost symbol per
    column and the rest 2..40; padding column and edge 0) and active [F]
    with frames 1 and F-1 frozen."""
    rng = np.random.default_rng(seed)
    q, n, e = g.q, g.code.n, g.n_edges
    app = (2 + 38 * rng.random((f, n + 1, q))).astype(np.float32)
    best = rng.integers(0, q, (f, n + 1))
    np.put_along_axis(app, best[..., None], rng.random((f, n + 1, 1)), -1)
    ctov = (10 * rng.random((f, e + 1, q))).astype(np.float32)
    app[:, n] = 0
    ctov[:, e] = 0
    app, ctov = torch.from_numpy(app), torch.from_numpy(ctov)
    app[:, plan["cols"]] += ctov[:, plan["edge_ids"]]
    active = torch.ones(f, dtype=torch.bool)
    active[1] = active[-1] = False
    return app, ctov, active


def pre_fusion_layer(app, ctov, active, p):
    """The layered SPA super-layer as the sweep ran it before the fused
    kernel (with the plain check node)."""
    act = active[:, None, None, None]
    app_rows = app[:, p["cols"]]
    ctov_rows = ctov[:, p["edge_ids"]]
    mvc = app_rows - ctov_rows
    mvc = mvc - mvc.min(dim=-1, keepdim=True).values
    t_in, t_out = fht.position_tables(p["coefs"], p["t_tab"], p["tinv_tab"])
    mcv = fht.spa_checknode_plain(mvc, t_in, t_out)
    mcv = mcv - mcv.min(dim=-1, keepdim=True).values
    mcv = torch.where(act, mcv, ctov_rows)
    new_app = torch.where(act, mvc + mcv, app_rows)
    ctov[:, p["edge_ids"]] = mcv
    app[:, p["cols"]] = new_app


def layer_args(p):
    return (p["cols32"], p["edge_ids32"], p["coefs"], p["t_tab"],
            p["tinv_tab"])


@pytest.mark.parametrize("kind", ["regular", "irregular"])
@pytest.mark.parametrize("dc", [3, 4, 6])
@pytest.mark.parametrize("q", [16, 64, 256])
def test_spa_layer_matches_pre_fusion_sweep(q, dc, kind):
    g = DeviceGraph.from_code(make_code(kind, q, dc))
    plans = layered._layer_plan(g, "cpu")
    if kind == "irregular":
        assert any(bool((p["coefs"] == 0).any()) for p in plans)
    before = cuda_spa.launches, cuda_spa.layer_launches
    for k, p in enumerate(plans):
        app, ctov, active = layer_state(g, p, f=5, seed=10 * q + dc + k)
        got = app.clone(), ctov.clone()
        cuda_spa.spa_layer(*got, active, *layer_args(p))
        want = app.clone(), ctov.clone()
        pre_fusion_layer(*want, active, p)
        real = (p["coefs"] != 0).numpy()
        own = {"app": p["cols"].numpy()[real],
               "ctov": p["edge_ids"].numpy()[real]}
        for name, x0, a, b in zip(("app", "ctov"), (app, ctov), got, want):
            x0, a, b = x0.numpy(), a.numpy(), b.numpy()
            rest = np.setdiff1d(np.arange(x0.shape[1]), own[name])
            # frozen frames and rows the layer does not own (padding
            # included): untouched, bit for bit, on both sides
            for y in (a, b):
                np.testing.assert_array_equal(y[~active.numpy()],
                                              x0[~active.numpy()])
                np.testing.assert_array_equal(y[:, rest], x0[:, rest])
            act = active.numpy()
            assert_costs_close(a[act][:, own[name]], b[act][:, own[name]],
                               err_msg=f"{name} layer {k}")
        # the padding column and edge stay 0
        assert (got[0][:, -1] == 0).all() and (got[1][:, -1] == 0).all()
    # CPU tensors run the plain version: no launch counted
    assert (cuda_spa.launches, cuda_spa.layer_launches) == before


def test_spa_sweep_calls_spa_layer_once_per_super_layer(monkeypatch):
    g = DeviceGraph.from_code(make_code("irregular", 16, 6))
    calls = []

    def counting(*args):
        calls.append(args[3].shape)
        return cuda_spa.spa_layer(*args)

    monkeypatch.setattr(layered, "spa_layer", counting)
    init, step = layered.make_layered_stepper(g, 0, 0.0, "spa")
    rng = np.random.default_rng(5)
    intr = torch.from_numpy((rng.random((4, g.code.n, 16)) * 5)
                            .astype(np.float32))
    step(step(init(intr)))
    assert len(calls) == 2 * len(g.layers)
    assert calls[:len(g.layers)] == [(len(rows), g.code.dc_max)
                                     for rows in g.layers]


def zero_word_frames(jc, f, ebn0, seed):
    """Intrinsics of the all-zero codeword through the JAX channel."""
    sigma = sigma_for(ChannelSpec(), ebn0, jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(seed),
                        jnp.zeros((f, jc.n), jnp.int32), jc.q, sigma)
    return np.array(intr)


FROZEN = np.array([1, 5])
# tests/test_torch_spa.py's hand-written irregular code: rows of degree 3,
# 4 and 5, columns of degree 1 to 3
IRREGULAR_ROWS = [[0, 1, 2, 3], [4, 5, 6], [7, 8, 9, 10, 11],
                  [12, 13, 14, 15], [0, 4, 7, 12, 1], [2, 5, 8, 13],
                  [3, 6, 9, 14, 10], [11, 15, 1, 5]]


def irregular16(q, seed=0):
    rng = np.random.default_rng(seed)
    rows = [np.asarray(r) for r in IRREGULAR_ROWS]
    coefs = [rng.integers(1, q, len(r)) for r in rows]
    return jfrom_parsed(JParsedMatrix(16, len(rows), q, rows, coefs),
                        name="irregular16")


def jax_irregular(q, dc, seed=0):
    rows = irregular_rows(16, 8, dc, seed)
    rng = np.random.default_rng(seed + 1)
    coefs = [rng.integers(1, q, len(r)) for r in rows]
    return jfrom_parsed(JParsedMatrix(16, len(rows), q, rows, coefs),
                        name="irregular16")


def test_decode_through_spa_layer_matches_jax():
    jc = jax_irregular(64, 6)
    intr = zero_word_frames(jc, 32, 0.5, seed=3)
    jcfg = JConfig(max_iters=12, schedule="layered", cn="spa", nm=0,
                   loop="host", storage="dense", dtype="float32")
    want = [np.asarray(x) for x in jdecode(jc, jnp.asarray(intr), jcfg)]
    # informative: some frames need several iterations, some converge
    assert want[1].max() > 1 and want[2].any()
    got = decode(from_jax_code(jc), torch.from_numpy(intr),
                 DecoderConfig(**dataclasses.asdict(jcfg)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_state_after_one_step_with_frozen_frames_matches_jax():
    """One step with frames 1 and 5 marked converged on both sides, so
    that the step freezes them."""
    jc = irregular16(16)
    intr = zero_word_frames(jc, 16, 0.5, seed=9)
    jinit, jstep = jmake_stepper(JGraph.from_code(jc), 0, 0.0, "spa")
    japp, jctov, jdec, jconv, jit = jinit(jnp.asarray(intr))
    jstate = jstep((japp, jctov, jdec, jconv.at[FROZEN].set(True), jit))
    g = DeviceGraph.from_code(from_jax_code(jc))
    init, step = layered.make_layered_stepper(g, 0, 0.0, "spa")
    app0, ctov0, dec0, conv0, it0 = init(torch.from_numpy(intr))
    conv0[torch.from_numpy(FROZEN)] = True
    tstate = step((app0.clone(), ctov0.clone(), dec0, conv0, it0))
    assert not np.asarray(jconv).all()
    np.testing.assert_array_equal(tstate[0][FROZEN].numpy(),
                                  app0[FROZEN].numpy())
    np.testing.assert_array_equal(tstate[1][FROZEN].numpy(),
                                  ctov0[FROZEN].numpy())
    for name, a, b in zip(("app", "ctov", "decide", "conv", "iters"),
                          tstate, jstate):
        b = np.asarray(b)
        if name in ("app", "ctov"):
            assert_costs_close(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def rejection_case(bad):
    """(arguments of spa_layer, expected exception) for one bad input."""
    f, n1, e1, g, dc, q = 3, 9, 13, 2, 4, 16
    app = torch.zeros((f, n1, q))
    ctov = torch.zeros((f, e1, q))
    active = torch.ones(f, dtype=torch.bool)
    idx = torch.arange(g * dc, dtype=torch.int32).reshape(g, dc)
    cols, edges, coefs = idx.clone(), idx.clone(), idx + 1
    t_tab, tinv_tab = (torch.from_numpy(t)
                       for t in fht.transpose_perm_tables(get_gf(q)))
    err = ValueError
    if bad == "float64":
        app, err = app.double(), TypeError
    elif bad == "ctov_float16":
        ctov, err = ctov.half(), TypeError
    elif bad == "2d":
        app = app.reshape(f * n1, q)
    elif bad == "noncontig":
        ctov = torch.zeros((e1, f, q)).transpose(0, 1)
    elif bad == "device":
        coefs = coefs.to("meta")
    elif bad == "cols_int64":
        cols = cols.long()
    elif bad == "edges_width":
        edges = edges[:, :3].contiguous()
    elif bad == "coefs_rows":
        coefs = torch.ones((g + 1, dc), dtype=torch.int32)
    elif bad == "active_uint8":
        active = active.to(torch.uint8)
    elif bad == "active_shape":
        active = torch.ones(f + 1, dtype=torch.bool)
    elif bad == "q_not_pow2":
        app, ctov = app[..., :12].contiguous(), ctov[..., :12].contiguous()
    elif bad == "q512":
        app, ctov = torch.zeros((f, n1, 512)), torch.zeros((f, e1, 512))
    elif bad == "dc1":
        cols, edges, coefs = (x[:, :1].contiguous()
                              for x in (cols, edges, coefs))
    elif bad == "table_shape":
        t_tab = t_tab[:8].contiguous()
    elif bad == "col_out_of_range":      # torch's own indexing checks it
        cols, err = cols + n1, IndexError
    elif bad == "smem":
        # one warp would need 12 dc q floats: past the block's limit
        q, dc = 256, 80
        app, ctov = torch.zeros((f, 200, q)), torch.zeros((f, 200, q))
        cols = edges = torch.zeros((1, dc), dtype=torch.int32)
        coefs = torch.ones((1, dc), dtype=torch.int32)
        t_tab, tinv_tab = (torch.from_numpy(t)
                           for t in fht.transpose_perm_tables(get_gf(q)))
    return (app, ctov, active, cols, edges, coefs, t_tab, tinv_tab), err


@pytest.mark.parametrize("bad", [
    "float64", "ctov_float16", "2d", "noncontig", "device", "cols_int64",
    "edges_width", "coefs_rows", "active_uint8", "active_shape",
    "q_not_pow2", "q512", "dc1", "table_shape", "col_out_of_range",
    "smem"])
def test_spa_layer_rejects_bad_inputs(bad):
    args, err = rejection_case(bad)
    with pytest.raises(err):
        cuda_spa.spa_layer(*args)


def test_smem_rejections_name_shared_memory():
    """The smem cases fail for their shared memory, not another reason:
    spa_layer at dc = 80, q = 256 and the bare entry at dc = 120 (which
    the bare entry's one-warp buffer cannot hold either), while dc = 40
    fits both."""
    args, _ = rejection_case("smem")
    with pytest.raises(ValueError, match="shared memory"):
        cuda_spa.spa_layer(*args)
    t_tab, tinv_tab = (torch.from_numpy(t)
                       for t in fht.transpose_perm_tables(get_gf(256)))
    with pytest.raises(ValueError, match="shared memory"):
        cuda_spa.spa_checknode(torch.zeros((2, 120, 256)),
                               torch.ones((1, 120), dtype=torch.int32),
                               t_tab, tinv_tab)
    assert cuda_spa.smem_bytes(40, 256, fused=True) <= 232448
    assert cuda_spa.smem_bytes(113, 256) > 232448 >= cuda_spa.smem_bytes(
        111, 256)


@pytest.mark.cuda
def test_spa_layer_matches_plain_on_card():
    """The fused entry against its plain version at small shapes (card
    only; chip_smoke.py runs the full-size comparison)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for q, dc, kind in [(256, 4, "regular"), (16, 6, "irregular"),
                        (64, 3, "irregular")]:
        g = DeviceGraph.from_code(make_code(kind, q, dc))
        for k, p in enumerate(layered._layer_plan(g, "cuda")):
            pc = layered._layer_plan(g, "cpu")[k]
            state = layer_state(g, pc, f=6, seed=k)
            app, ctov, active = (x.cuda() for x in state)
            got = app.clone(), ctov.clone()
            before = cuda_spa.layer_launches
            cuda_spa.spa_layer(*got, active, *layer_args(p))
            assert cuda_spa.layer_launches == before + 1
            want = app.clone(), ctov.clone()
            cuda_spa.spa_layer_plain(*want, active, *layer_args(p))
            for a, b in zip(got, want):
                torch.testing.assert_close(torch.exp(-a), torch.exp(-b),
                                           rtol=0, atol=1e-5)
            assert torch.equal(got[0][~active], app[~active])
            assert torch.equal(got[1][~active], ctov[~active])
