"""The syndrome-EMS check node (``cn="syndrome"``): the port against the
JAX package.

The same inputs, made from a seeded numpy generator, go through the JAX
package's ``ops/syndrome_cn`` and decoders and through the port's
``ops/syndrome_cn`` (plain torch), ``ops/cuda_syndrome.syndrome_rows`` (on
a CPU tensor: its plain version ``syndrome_rows_plain``) and decoders.
Tolerance: none.  Every step is integer or bf16-key logic, selections and
gathers, but for three f32 operations (the config sums in slot order,
bayes' multiply, sat + offset) that both sides do in the same order, so
tables, CN outputs and decodes (decisions, iterations, convergence) must
be equal.  "ties" inputs draw a few integer levels, so that equal values
(list order, bucket duplicates, the bayes thresholds, ties at the
saturation level and the ``keep`` rank) are common.  The JAX side runs
jitted (one compile per shape and configuration, seconds, against tens of
seconds op by op), and the cases share a few shapes."""
import dataclasses
import functools
import json

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
from ems_nbldpc_tpu.ops import syndrome_cn as jsyn

from ems_nbldpc_torch import cli
from ems_nbldpc_torch.decoder import api, device_loop, flooding, layered
from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.graph import DeviceGraph, rotation_table
from ems_nbldpc_torch.models.code import from_jax_code, load
from ems_nbldpc_torch.models.formats import ParsedMatrix
from ems_nbldpc_torch.models.tools import write_ubs
from ems_nbldpc_torch.ops import cuda_syndrome, syndrome_cn
from ems_nbldpc_torch.ops.minconv import topk_message
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig

OFFSET = 0.3
SMALL = dict(d1=7, d2=3, d3=2)          # a small table, C = 89 at dc = 4


def rows(shape, kind, seed):
    """Min-normalised messages [..., q] ("ties": integer levels 0..5)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        v = rng.integers(0, 6, shape).astype(np.float32)
    else:
        v = (rng.random(shape) * 9).astype(np.float32)
    return v - v.min(axis=-1, keepdims=True)


@functools.lru_cache(maxsize=None)
def jax_cn(q, **kw):
    """JAX's ``syndrome_checknode`` for ``q`` and ``kw``, jitted."""
    return jax.jit(functools.partial(jsyn.syndrome_checknode, q=q,
                                     offset=OFFSET, **kw))


def lists(shape, q, nm, kind, seed):
    """The nm best (values, ids) of seeded messages, through JAX's
    ``topk_message`` (the lists both CNs are given)."""
    vals, ids = jmc.topk_message(jnp.asarray(rows(shape + (q,), kind, seed)),
                                 nm)
    return np.asarray(vals), np.asarray(ids)


# ---------------- host tables ----------------

@pytest.mark.parametrize("shape", ["full", "trapeze", "2dev", "bordered"])
@pytest.mark.parametrize("dc", [4, 6, 12])
def test_config_tables_equal_jax(dc, shape):
    caps = [1000, 0] if dc < 12 or shape in ("2dev", "bordered") else [1000]
    for cap in caps:
        want = jsyn.build_config_table(dc, 7, 3, 2, shape, cap)
        got = syndrome_cn.build_config_table(dc, 7, 3, 2, shape, cap)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if dc == 4:       # the default recipe at nm = 32 (d1 clipped to 31)
        np.testing.assert_array_equal(
            syndrome_cn.build_config_table(4, 31, 15, 5, shape),
            jsyn.build_config_table(4, 31, 15, 5, shape))


def test_default_table_and_saturation_ranks():
    """At the full-width code's dc = 4, nm = 32: C = 993 configs, 489 of
    them deviation-free on each edge; kth = n_cv - 1 + 3t."""
    cfg, kth = syndrome_cn.syndrome_tables(4, 32)
    assert cfg.shape == (993, 4)
    assert ((cfg == 0).sum(axis=0) == 489).all()
    np.testing.assert_array_equal(kth, [44, 47, 50, 53])
    cfg, kth = syndrome_cn.syndrome_tables(4, 32, sat_rule="median")
    np.testing.assert_array_equal(kth, [244] * 4)


# ---------------- device ops ----------------

def test_bayes_combine_equals_jax():
    """Differences on and around every threshold (0.1, 0.2, 1, 2), equal
    values, INF and values past INF / 2."""
    m1 = np.repeat(np.float32([0, 0.5, 3, 7.25, 1e8, 6e8]), 12)
    dif = np.tile(np.float32([0, 0.05, 0.1, 0.125, 0.2, 0.5, 1, 1.5, 2, 3,
                              1e9, np.inf]), 6)
    m2 = (m1 + dif).astype(np.float32)
    want = np.asarray(jsyn.bayes_combine(jnp.asarray(m1), jnp.asarray(m2)))
    got = syndrome_cn.bayes_combine(torch.from_numpy(m1), torch.from_numpy(m2))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dc", [3, 4, 6])
def test_presort_order_equals_jax(dc):
    vals = np.sort(rows((50, dc, 8), "ties", seed=dc), axis=-1)
    want = np.asarray(jsyn.presort_order(jnp.asarray(vals)))
    got = syndrome_cn.presort_order(torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)


CN_CASES = [  # q, dc, nm, parameters
    (16, 4, 8, dict(SMALL)),
    (16, 4, 8, dict(SMALL, use_bayes=False)),
    (16, 4, 8, dict(SMALL, presort=False, sat_rule="median")),
    (16, 4, 8, dict(SMALL, use_bayes=False, presort=False)),
    (64, 6, 12, dict(n_cv=20, shape="bordered", d1=9, d2=4)),
    (64, 6, 12, dict(n_cv=20, shape="2dev", d1=11, sat_rule="median")),
    (256, 4, 32, dict()),
]


@pytest.mark.parametrize("q,dc,nm,kw", CN_CASES)
@pytest.mark.parametrize("kind", ["ties", "uniform"])
def test_syndrome_checknode_equals_jax(q, dc, nm, kw, kind):
    vals, ids = lists((3 if q == 256 else 7, 5, dc), q, nm, kind,
                      seed=q + dc)
    want = np.asarray(jax_cn(q, **kw)(jnp.asarray(vals), jnp.asarray(ids)))
    got = syndrome_cn.syndrome_checknode(
        torch.from_numpy(vals), torch.from_numpy(ids), q, offset=OFFSET,
        **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def torch_tables(dc, nm, **kw):
    cfg, kth = syndrome_cn.syndrome_tables(dc, nm, **kw)
    return (torch.from_numpy(cfg.astype(np.uint8)),
            torch.from_numpy(kth.astype(np.int32)))


@pytest.mark.parametrize("kind", ["ties", "uniform"])
def test_syndrome_rows_plain_equals_jax_composition(kind):
    """On a padded irregular layer (G = 5 rows, some slots padding): JAX's
    rotation (a gather through its GF tables), neutral padding slots,
    ``topk_message``, ``syndrome_checknode``, rotation back and
    normalisation, as its decoders compose them."""
    f, g, dc, q, nm = 3, 5, 4, 16, 8
    rng = np.random.default_rng(1)
    coefs = rng.integers(1, q, (g, dc))
    coefs[0, -1] = coefs[3, 1] = coefs[4, 0] = 0
    valid = coefs != 0
    gf = jget_gf(q)
    h = np.where(valid, coefs, 1)
    t_in, t_out = gf.mul_table[gf.inv(h)], gf.mul_table[h]
    x = rows((f, g, dc, q), kind, seed=2)
    vr = np.take_along_axis(x, np.broadcast_to(t_in, x.shape), -1)
    vr = np.where(valid[..., None], vr,
                  np.asarray(jmc.delta_message(vr.shape[:-1], q)))
    vals, ids = jmc.topk_message(jnp.asarray(vr), nm)
    out = np.asarray(jax_cn(q, **SMALL)(vals, ids))
    out = np.take_along_axis(out, np.broadcast_to(t_out, out.shape), -1)
    want = out - out.min(axis=-1, keepdims=True)
    rin, rout = (torch.from_numpy(rotation_table(coefs, jget_gf(q), d)
                                  .reshape(g, dc, q).astype(np.uint8))
                 for d in ("in", "out"))
    table, kth = torch_tables(dc, nm, **SMALL)
    got = cuda_syndrome.syndrome_rows(
        torch.from_numpy(x.reshape(f * g, dc, q)), rin, rout,
        torch.from_numpy(valid), table, kth, nm, OFFSET, True, True)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)


def test_cpu_calls_count_no_launch():
    x = torch.from_numpy(rows((6, 4, 16), "uniform", seed=3))
    tab = torch.arange(16, dtype=torch.uint8).repeat(3, 4, 1)
    table, kth = torch_tables(4, 8, **SMALL)
    before = cuda_syndrome.launches
    cuda_syndrome.syndrome_rows(x, tab, tab, None, table, kth, 8, OFFSET,
                                True, True)
    assert cuda_syndrome.launches == before


BAD = ["x_float64", "table_int64", "table_dc", "kth_int64", "kth_shape",
       "nm_over_q", "nm2_presort", "q_over_256", "too_many_configs",
       "over_shared_memory"]


@pytest.mark.parametrize("bad", BAD)
def test_syndrome_rows_rejects_what_the_kernel_cannot_hold(bad):
    """Bad inputs and configurations past the kernel's limits raise on any
    device; the plain version is never run in their place."""
    g, dc, q, nm = 3, 4, 16, 8
    x = torch.from_numpy(rows((2 * g, dc, q), "uniform", seed=0))
    tab = torch.zeros((g, dc, q), dtype=torch.uint8)
    table, kth = torch_tables(dc, nm, **SMALL)
    presort, err = True, ValueError
    if bad == "x_float64":
        x, err = x.double(), TypeError
    elif bad == "table_int64":
        table = table.long()
    elif bad == "table_dc":
        table = table[:, :3].contiguous()
    elif bad == "kth_int64":
        kth = kth.long()
    elif bad == "kth_shape":
        kth = kth[:3].contiguous()
    elif bad == "nm_over_q":
        nm = 17
    elif bad == "nm2_presort":
        nm = 2
    elif bad == "q_over_256":
        x = torch.zeros((2, dc, 512))
        tab = torch.zeros((1, dc, 512), dtype=torch.uint8)
    elif bad == "too_many_configs":
        table = torch.zeros((65537, dc), dtype=torch.uint8)
    elif bad == "over_shared_memory":
        # 40,000 configs, all with no deviation: 6 B each per warp (the
        # syndromes, and the keys past the registers' 512 a position)
        table = torch.zeros((40000, dc), dtype=torch.uint8)
    with pytest.raises(err):
        cuda_syndrome.syndrome_rows(x, tab, tab, None, table, kth, nm,
                                    OFFSET, True, presort)


def test_uncapped_high_degree_table_raises():
    """``syn_max_configs=0`` at dc = 20 builds 102,081 configurations: past
    the kernel's 65,536, so the decoder refuses it (ValueError), on any
    device, before a step runs."""
    cfg, _ = syndrome_cn.syndrome_tables(20, 32, max_configs=0)
    assert cfg.shape[0] == 102081
    with pytest.raises(ValueError, match="C=102081"):
        flooding.check_supported(0, 256, "syndrome", "auto",
                                 dict(max_configs=0), dc=20)
    # the capped default fits
    flooding.check_supported(0, 256, "syndrome", "auto", None, dc=20)


# ---------------- decodes ----------------

@functools.lru_cache(maxsize=None)
def frames(f=16, ebn0=2.5):
    """A GF(16) code with 2 super-layers and the JAX channel's intrinsics
    of its all-zero word."""
    jc = jrandom_regular(48, 24, 16, seed=3)
    sigma = sigma_for(ChannelSpec(), ebn0, jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(1), jnp.zeros((f, jc.n), jnp.int32),
                        jc.q, sigma)
    return jc, np.array(intr)


@functools.lru_cache(maxsize=None)
def jax_decode(schedule, **kw):
    """JAX ``decode`` of ``frames()`` under its host loop (a jitted step;
    cheaper to compile than its ``while_loop``, which runs the same
    step)."""
    jc, intr = frames()
    cfg = JConfig(max_iters=6, schedule=schedule, cn="syndrome", nm=8,
                  offset=OFFSET, syn_d=(7, 3, 2), loop="host", **kw)
    return [np.asarray(x) for x in jdecode(jc, jnp.asarray(intr), cfg)]


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_decode_equals_jax(schedule, loop):
    """Both schedules under both loops: decisions, iterations and
    convergence equal to JAX ``decode`` with the same config."""
    jc, intr = frames()
    want = jax_decode(schedule)
    # informative: some frames converge, at different iterations
    assert want[2].any() and len(set(want[1].tolist())) > 1
    cfg = DecoderConfig(max_iters=6, schedule=schedule, cn="syndrome", nm=8,
                        offset=OFFSET, syn_d=(7, 3, 2), loop=loop)
    got = decode(from_jax_code(jc), torch.from_numpy(intr), cfg)
    for name, a, b in zip(("decide", "iters", "conv"), got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_decode_with_switches_off_equals_jax():
    """bayes and presort off, the median saturation, the host loop."""
    jc, intr = frames()
    kw = dict(syn_bayes=False, syn_presort=False, syn_sat="median")
    want = jax_decode("layered", **kw)
    cfg = DecoderConfig(max_iters=6, cn="syndrome", nm=8, offset=OFFSET,
                        syn_d=(7, 3, 2), loop="host", **kw)
    got = decode(from_jax_code(jc), torch.from_numpy(intr), cfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_plain_argument_runs_the_same_decode():
    """``plain`` (the card's comparison path) is the CPU path here."""
    jc, intr = frames()
    g = DeviceGraph.from_code(from_jax_code(jc))
    syn = dict(d1=7, d2=3, d3=2)
    outs = [layered.decode_layered_hostloop(
        g, torch.from_numpy(intr), 6, 8, OFFSET, "syndrome", syn=syn,
        plain=plain) for plain in (False, True)]
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
@pytest.mark.parametrize("loop", ["device", "host"])
def test_decode_passes_syn_on_dense_routes(monkeypatch, schedule, loop):
    """``decode`` builds JAX's ``syn`` dict from the ``syn_*`` fields and
    passes it on every dense route (None for other CNs)."""
    seen = {}

    def record(g, intrinsic, max_iters, **kw):
        seen.update(kw)
        return "decoded"

    name = {("layered", "device"): "decode_layered",
            ("layered", "host"): "decode_layered_hostloop",
            ("flooding", "device"): "decode_flooding",
            ("flooding", "host"): "decode_flooding_hostloop"}[schedule, loop]
    monkeypatch.setattr(api, name, record)
    jc, _ = frames()
    cfg = DecoderConfig(schedule=schedule, loop=loop, cn="syndrome",
                        syn_ncv=30, syn_d=(9, 4, 3), syn_shape="full",
                        syn_max_configs=77, syn_bayes=False,
                        syn_presort=False, syn_sat="median")
    intr = torch.zeros((2, jc.n, jc.q))
    assert decode(from_jax_code(jc), intr, cfg) == "decoded"
    assert seen["syn"] == dict(n_cv=30, d1=9, d2=4, d3=3, shape="full",
                               max_configs=77, use_bayes=False,
                               presort=False, sat_rule="median")
    decode(from_jax_code(jc), intr, dataclasses.replace(cfg, cn="ems"))
    assert seen["syn"] is None


def test_two_syndrome_configs_do_not_share_a_device_loop():
    """Two syndrome settings are two loops (the key carries ``syn``), each
    equal to its host-loop decode."""
    jc, intr = frames()
    code = from_jax_code(jc)
    device_loop.clear()
    loops, outs = [], {}
    for bayes in (True, False):
        cfg = DecoderConfig(max_iters=6, cn="syndrome", nm=8, offset=OFFSET,
                            syn_d=(7, 3, 2), syn_bayes=bayes)
        outs[bayes] = decode(code, torch.from_numpy(intr), cfg)
        loops.append(device_loop.last())
        host = decode(code, torch.from_numpy(intr),
                      dataclasses.replace(cfg, loop="host"))
        assert all(torch.equal(a, b) for a, b in zip(outs[bayes], host))
    assert loops[0] is not loops[1]
    assert not all(torch.equal(a, b) for a, b in zip(outs[True],
                                                     outs[False]))
    device_loop.clear()


@pytest.mark.cuda
def test_syndrome_rows_kernel_matches_plain_on_card():
    """The kernel against its plain version at small shapes, with padding,
    every switch and table shape (card only; chip_smoke.py runs the main
    paths' shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for q, dc, nm, kw in CN_CASES:
        kw = dict(kw)
        bayes, presort = kw.pop("use_bayes", True), kw.pop("presort", True)
        f, g = 7, 11
        x = torch.from_numpy(rows((f * g, dc, q), "ties", seed=q)).cuda()
        coefs = np.random.default_rng(dc).integers(1, q, (g, dc))
        coefs[0, -1] = 0
        rin, rout = (torch.from_numpy(rotation_table(coefs, jget_gf(q), d)
                                      .reshape(g, dc, q).astype(np.uint8))
                     .cuda() for d in ("in", "out"))
        valid = torch.from_numpy(coefs != 0).cuda()
        table, kth = (t.cuda() for t in torch_tables(dc, nm, **kw))
        before = cuda_syndrome.launches
        got = cuda_syndrome.syndrome_rows(x, rin, rout, valid, table, kth, nm,
                                          OFFSET, bayes, presort)
        assert cuda_syndrome.launches == before + 1
        want = cuda_syndrome.syndrome_rows_plain(x, rin, rout, valid, table,
                                                 kth, nm, OFFSET, bayes,
                                                 presort)
        assert torch.equal(got, want), (q, dc, nm, kw)


def test_topk_message_is_the_lists_jax_takes():
    """The lists the plain step takes equal JAX's ``topk_message`` (lower
    id first among equal values)."""
    v = rows((40, 16), "ties", seed=9)
    vals, ids = jmc.topk_message(jnp.asarray(v), 8)
    got = topk_message(torch.from_numpy(v), 8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(vals))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ids))


def test_cli_syndrome_point_equals_monte_carlo(tmp_path):
    """``--cn syndrome`` runs with the ``DecoderConfig`` defaults (no
    ``syn_*`` flag, as in JAX's CLI): the point equals ``MonteCarlo.run``
    of the same config and seed, counter for counter."""
    jc, _ = frames()
    path = str(tmp_path / "code.txt")
    write_ubs(ParsedMatrix(jc.n, jc.m_rows, jc.q,
                           [jc.row_cols[r, :d] for r, d in
                            enumerate(jc.row_deg)],
                           [jc.row_coefs[r, :d] for r, d in
                            enumerate(jc.row_deg)]), path)
    out = tmp_path / "out"
    assert cli.main(["--matrix", path, "--cn", "syndrome", "--ebn0", "2.5",
                     "--iters", "6", "--nm", "8", "--batch", "16",
                     "--max-frames", "32", "--device", "cpu", "--out",
                     str(out), "--quiet"]) == 0
    (rec,) = [json.loads(x) for x in (out / "results.jsonl").open()]
    cfg = SimConfig(ebn0_db=2.5, frames_per_batch=16, max_frames=32,
                    decoder=DecoderConfig(max_iters=6, cn="syndrome", nm=8))
    res = MonteCarlo(load(path, name=path), cfg, device="cpu").run()
    assert (rec["frames"], rec["frame_errors"], rec["bit_errors"],
            round(rec["avg_iters"] * rec["frames"])) == (
        res.frames, res.frame_errors, res.bit_errors, res.iter_sum)
    assert res.frames == 32 and res.iter_sum > res.frames
