"""The device-loop decoders (``loop="device"``): the port against its own
host loop and against the JAX package's ``while_loop`` decodes.

The same intrinsics (from the JAX channel, as numpy) go through
* the port's ``decode(loop="device")`` (``decoder/device_loop``: on the
  CPU its schedule runs eagerly on the loop's static buffers; the capture
  itself needs the card, see the ``cuda`` tests at the end) and
  ``decode(loop="host")``: decisions, iteration counts and convergence
  flags identical;
* JAX ``decode(loop="device")``: integer outputs identical.  The port's
  ``cn_impl="pallas"`` runs the CUDA kernel's plain version on CPU
  tensors, against JAX's exact reference ``topk``, and against the JAX
  Pallas kernel itself in interpret mode in one small case.  SPA: identical
  decisions, iterations and convergence, as ``tests/test_torch_spa.py``
  holds whole SPA decodes (its state tolerance does not enter: a decode
  returns integers).  bf16 list storage: decisions of the frames both
  sides converge, as ``tests/test_torch_list.py`` holds them.
Cases: frames that converge at different iterations with some that hit
the budget ("mixed"), and frames that all converge at init ("init").
"""
import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ems_nbldpc_tpu.ops.pallas_cn as jpallas
from ems_nbldpc_tpu.decoder.api import DecoderConfig as JConfig
from ems_nbldpc_tpu.decoder.api import decode as jdecode
from ems_nbldpc_tpu.models.channels import ChannelSpec, bpsk_awgn, sigma_for
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular

from ems_nbldpc_torch.decoder import device_loop
from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.graph import DeviceGraph, clear_tables, upload
from ems_nbldpc_torch.decoder.layered import _layer_plan, make_layered_stepper
from ems_nbldpc_torch.models.code import from_jax_code
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig

CODES = {  # n, m, q: GF(16) with 2 super-layers, GF(64) with 3
    16: (48, 24, 16),
    64: (48, 24, 64),
}
CASES = {  # Eb/N0 (dB), budget
    "mixed": (1.0, 6),
    "init": (30.0, 6),
}
CONFIGS = {  # name -> (GF, decoder fields)
    "layered ems topk": (16, dict(cn="ems", nm=8, cn_impl="topk")),
    "layered ems pallas": (64, dict(cn="ems", nm=12, cn_impl="pallas")),
    "layered minsum": (16, dict(cn="minsum", nm=0, cn_impl="auto")),
    "layered spa": (16, dict(cn="spa", nm=0)),
    "list f32 nboper 0": (16, dict(cn="ems", nm=8, storage="compressed",
                                   nboper=0)),
    "list bf16 nboper 64": (64, dict(cn="ems", nm=12, storage="compressed",
                                     nboper=64, dtype="bfloat16")),
    "flooding ems pallas": (16, dict(schedule="flooding", cn="ems", nm=8,
                                     cn_impl="pallas")),
    "flooding spa": (64, dict(schedule="flooding", cn="spa", nm=0)),
}


@functools.lru_cache(maxsize=None)
def frames(q, case, f=32):
    """(JAX code, intrinsics of its all-zero codeword) through the JAX
    channel at the case's Eb/N0."""
    n, m, _ = CODES[q]
    jc = jrandom_regular(n, m, q, seed=q)
    sigma = sigma_for(ChannelSpec(), CASES[case][0], jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(q), jnp.zeros((f, n), jnp.int32),
                        q, sigma)
    return jc, np.array(intr)


@functools.lru_cache(maxsize=None)
def port_code(q):
    return from_jax_code(frames(q, "mixed")[0])


def config(name, case, **change):
    q, fields = CONFIGS[name]
    cfg = DecoderConfig(max_iters=CASES[case][1], offset=0.3, **fields)
    return q, dataclasses.replace(cfg, **change)


def assert_informative(iters, conv, case, budget):
    if case == "init":
        assert conv.all() and (iters == 0).all()
    else:   # different iteration counts, and some frames hit the budget
        assert len(np.unique(iters[conv])) > 1 and conv.any()
        assert (iters == budget).any()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_device_loop_matches_host_loop(name, case):
    q, cfg = config(name, case)
    intr = torch.from_numpy(frames(q, case)[1])
    got = decode(port_code(q), intr, cfg)
    want = decode(port_code(q), intr, dataclasses.replace(cfg, loop="host"))
    for label, a, b in zip(("decide", "iters", "conv"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), label
    assert_informative(got[1].numpy(), got[2].numpy(), case, cfg.max_iters)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_device_loop_matches_jax_while_loop(name, case):
    q, cfg = config(name, case)
    jc, intr = frames(q, case)
    jcfg = JConfig(**dict(dataclasses.asdict(cfg), cn_impl="topk")
                   if cfg.cn_impl == "pallas" else dataclasses.asdict(cfg))
    assert jcfg.loop == "device"
    want = [np.asarray(x) for x in jdecode(jc, jnp.asarray(intr), jcfg)]
    got = [x.numpy() for x in decode(port_code(q), torch.from_numpy(intr),
                                     cfg)]
    if cfg.dtype == "bfloat16":
        both = got[2] & want[2]
        assert both.any()
        np.testing.assert_array_equal(got[0][both], want[0][both])
        return
    for label, a, b in zip(("decide", "iters", "conv"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=label)


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_device_loop_matches_jax_pallas_interpret(monkeypatch, schedule):
    """The JAX side runs its Pallas kernel itself, in interpret mode,
    inside its while_loop (2 super-layers, nm = 4, as the host-loop
    interpret tests)."""
    monkeypatch.setattr(
        jpallas, "fb_checknode_pallas",
        functools.partial(jpallas.fb_checknode_pallas, tile=16,
                          interpret=True))
    jc = jrandom_regular(16, 8, 16, seed=0)
    sigma = sigma_for(ChannelSpec(), 2.0, jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(0), jnp.zeros((4, 16), jnp.int32),
                        16, sigma)
    jcfg = JConfig(max_iters=4, schedule=schedule, cn="ems", nm=4,
                   offset=0.3, cn_impl="pallas", loop="device")
    want = [np.asarray(x) for x in jdecode(jc, intr, jcfg)]
    assert want[1].max() > 1 and want[2].any()
    got = decode(from_jax_code(jc), torch.from_numpy(np.array(intr)),
                 DecoderConfig(**dataclasses.asdict(jcfg)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_default_config_decodes():
    """``DecoderConfig()``'s defaults (``loop="device"``, layered, cn="ems"
    with nm = 0) decode: nm = 0 means no truncation, so the EMS CN is the
    exact min-sum CN, the same decode as cn="minsum", nm = 0.  (The JAX
    package raises a TypeError at this nm; its min-sum decode is the
    reference.)"""
    jc, intr = frames(16, "mixed")
    got = decode(port_code(16), torch.from_numpy(intr), DecoderConfig())
    minsum = JConfig(cn="minsum")
    want = [np.asarray(x) for x in jdecode(jc, jnp.asarray(intr), minsum)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    assert want[1].max() > 1 and want[2].any()


def test_reused_loop_equals_fresh_loops():
    """One cached loop decoding two batches in turn gives what two fresh
    loops give; the second decode finds the first's loop."""
    q, cfg = config("layered ems pallas", "mixed")
    batches = [torch.from_numpy(frames(q, "mixed")[1]),
               torch.from_numpy(frames(q, "mixed", f=32)[1][::-1].copy())]
    device_loop.clear()
    reused, loops = [], []
    for x in batches:
        reused.append(decode(port_code(q), x, cfg))
        loops.append(device_loop.last())
    assert loops[0] is loops[1] and len(device_loop._cache) == 1
    fresh = []
    for x in batches:
        device_loop.clear()
        fresh.append(decode(port_code(q), x, cfg))
    for r, f in zip(reused, fresh):
        assert all(torch.equal(a, b) for a, b in zip(r, f))
    assert not torch.equal(reused[0][1], reused[1][1])


def test_reset_undoes_steps():
    """The steps run before a decode (on the card: the warm-up step before
    capture) shift no count: each decode resets the buffers and the step
    counter."""
    q, cfg = config("layered ems topk", "mixed")
    g = DeviceGraph.from_code(port_code(q))
    intr = torch.from_numpy(frames(q, "mixed")[1])
    loop = device_loop.DeviceLoop(
        *make_layered_stepper(g, cfg.nm, cfg.offset, cfg.cn, cfg.cn_impl),
        cfg.max_iters)
    loop._reset(intr)
    for _ in range(3):
        loop._step()
    assert int(loop.it) == 3
    got = loop(intr)
    want = decode(g, intr, dataclasses.replace(cfg, loop="host"))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(loop.it) == int(want[1].max())


def test_cache_is_bounded_and_held_loops_survive():
    """The cache keeps the newest ``MAX_CACHED`` loops; a loop it dropped
    and its caller still holds decodes as before, with the tables its
    steps read kept by the loop itself."""
    q, cfg = config("layered ems topk", "mixed")
    intr = torch.from_numpy(frames(q, "mixed")[1])
    device_loop.clear()
    want = decode(port_code(q), intr, cfg)
    mine = device_loop.last()
    for it in range(2, 2 + device_loop.MAX_CACHED + 1):
        decode(port_code(q), intr, dataclasses.replace(cfg, max_iters=it))
    assert len(device_loop._cache) == device_loop.MAX_CACHED
    assert mine not in device_loop._cache.values()
    assert all(torch.equal(a, b) for a, b in zip(mine(intr), want))
    decode(port_code(q), intr, cfg)
    assert device_loop.last() is not mine       # made anew, not found


def test_loop_keeps_the_tables_its_step_read():
    """The tables a loop's step read (on the card: the captured step, whose
    graph reads them by address) stay alive with the loop when every table
    cache is emptied, and the loop's next decode is unchanged."""
    q, cfg = config("layered ems pallas", "mixed")
    g = DeviceGraph.from_code(port_code(q))
    intr = torch.from_numpy(frames(q, "mixed")[1])
    device_loop.clear()
    first = decode(g, intr, cfg)
    loop = device_loop.last()
    plan, tabs = _layer_plan(g, "cpu"), upload(g, "cpu")
    assert {id(plan), id(tabs)} <= set(loop.tables)
    refs = [weakref.ref(t) for t in (plan[0]["rot_in8"], tabs["row_edges"])]
    clear_tables()
    del plan, tabs
    gc.collect()
    assert all(r() is not None for r in refs)
    assert all(torch.equal(a, b)
               for a, b in zip(decode(g, intr, cfg), first))
    assert device_loop.last() is loop


def test_monte_carlo_keeps_one_loop_and_matches_host_loop():
    """The Monte-Carlo chain with the default loop: one loop serves every
    batch and two Eb/N0 points, counter for counter as with the host
    loop."""
    code = port_code(16)
    dec = DecoderConfig(max_iters=8, cn="ems", nm=8, cn_impl="pallas")
    kw = dict(frames_per_batch=16, max_frames=48, stop_errors=10**9)
    mc = MonteCarlo(code, SimConfig(ebn0_db=1.5, decoder=dec, **kw),
                    device="cpu")
    host = MonteCarlo(code, SimConfig(ebn0_db=1.5, decoder=dataclasses.replace(
        dec, loop="host"), **kw), device="cpu")
    device_loop.clear()
    loops = set()
    for ebn0 in (1.5, 2.5):
        mc.cfg = dataclasses.replace(mc.cfg, ebn0_db=ebn0)
        host.cfg = dataclasses.replace(host.cfg, ebn0_db=ebn0)
        a = mc.run()
        loops.add(device_loop.last())
        b = host.run()
        assert (a.frames, a.frame_errors, a.bit_errors, a.iter_sum,
                a.decoder_steps) == (b.frames, b.frame_errors, b.bit_errors,
                                     b.iter_sum, b.decoder_steps)
        assert a.iter_sum > a.frames
    assert len(loops) == 1 and len(device_loop._cache) == 1


@pytest.mark.cuda
def test_capture_on_card():
    """On the card: one graph launch per decode, bit-equal to the host
    loop, the warm-up shifting no count; a replay makes no eager launch,
    and the kernel counts per-step launches times the steps run on the
    card; emptying the table caches between two replays changes nothing
    (chip_smoke.py phase 6 runs the full-width comparison)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the capture has no CPU mode")
    from ems_nbldpc_torch.ops import cuda_cn
    q, cfg = config("layered ems pallas", "mixed")
    intr = torch.from_numpy(frames(q, "mixed")[1]).cuda()
    device_loop.clear()
    first = decode(port_code(q), intr, cfg)
    loop = device_loop.last()
    clear_tables()
    gc.collect()
    torch.cuda.empty_cache()
    # refill the freed memory, small blocks and large
    junk = [torch.full((1 << k,), -7, dtype=torch.int64, device="cuda")
            for k in range(8, 25, 2) for _ in range(4)]
    eager = cuda_cn.launches
    cuda_cn.reset_device_launches()
    second = decode(port_code(q), intr, cfg)
    ran = cuda_cn.device_launches()
    assert device_loop.last() is loop and cuda_cn.launches == eager
    want = decode(port_code(q), intr, dataclasses.replace(cfg, loop="host"))
    steps = int(want[1].max())
    assert loop.per_step["fb_checknode"] == len(port_code(q).layers)
    assert ran == loop.per_step["fb_checknode"] * steps
    for got in (first, second):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    del junk
