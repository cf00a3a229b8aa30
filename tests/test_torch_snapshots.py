"""Iteration-budget snapshots and two-phase decoding: the port against the
JAX package and against the port's own Monte-Carlo chain.

* ``snapshot_batch`` fed JAX's intrinsic gives, at every budget, the frame
  and bit errors of JAX's stepper loop (``ems_nbldpc_tpu/sim/snapshots.py``)
  run on it; the port's ``cn_impl="pallas"`` (the CUDA kernel's plain
  version on CPU tensors) against JAX's ``topk``, its exact reference.
* ``run_snapshots`` draws ``MonteCarlo.run``'s batches: at its largest
  budget it equals the host-loop run frame for frame.
* ``run_twophase`` equals ``MonteCarlo.run`` on all five counters (phase B
  restarts from the intrinsic), for layered EMS and SPA under both loops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ems_nbldpc_tpu.decoder.graph import DeviceGraph as JGraph
from ems_nbldpc_tpu.decoder.layered import \
    make_layered_stepper as jmake_stepper
from ems_nbldpc_tpu.models.channels import ChannelSpec, bpsk_awgn, sigma_for
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular
from ems_nbldpc_tpu.models.encoder import \
    gaussian_elimination as jgaussian_elimination

from ems_nbldpc_torch.decoder import device_loop
from ems_nbldpc_torch.decoder.api import DecoderConfig
from ems_nbldpc_torch.decoder.flooding import decode_flooding_hostloop
from ems_nbldpc_torch.decoder.graph import DeviceGraph
from ems_nbldpc_torch.decoder.layered import make_layered_stepper
from ems_nbldpc_torch.decoder.stats import decode_flooding_stats
from ems_nbldpc_torch.models.code import from_jax_code, random_regular
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig
from ems_nbldpc_torch.sim.snapshots import run_snapshots, snapshot_batch
from ems_nbldpc_torch.sim.twophase import run_twophase

EMS = dict(max_iters=10, schedule="layered", cn="ems", nm=8, offset=0.3,
           cn_impl="pallas")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread for these small decodes: the suite runs
    in parallel workers, each of which would otherwise spin a thread per
    core on tiny ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_frames(n, m, q, f, ebn0, seed):
    """A JAX code, codewords (numpy back-substitution) and intrinsics."""
    jc = jrandom_regular(n, m, q, seed=seed)
    info = np.random.default_rng(seed).integers(0, q, (f, jc.k))
    cw = jgaussian_elimination(jc).encode_np(info)
    sigma = sigma_for(ChannelSpec(), ebn0, jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(seed), jnp.asarray(cw, jnp.int32),
                        q, sigma)
    return jc, cw, np.array(intr)


def jax_snapshots(jc, intr, cw, budgets, nm):
    """JAX's ``run_snapshots`` loop on one batch (its count: bit errors
    over the first k symbols, a frame error above 0 bits)."""
    init_fn, step_fn = jmake_stepper(JGraph.from_code(jc), nm=nm,
                                     offset=0.3, cn="ems", cn_impl="topk")
    state = init_fn(jnp.asarray(intr))
    it, fe, be = 0, {}, {}
    for b in budgets:
        while it < b and not bool(np.asarray(state[3].all())):
            state = step_fn(state)
            it += 1
        diff = np.asarray(state[2])[:, :jc.k] ^ cw[:, :jc.k]
        bits = sum((diff >> i) & 1 for i in range(8)).sum(axis=1)
        fe[b], be[b] = int((bits > 0).sum()), int(bits.sum())
    return fe, be


def test_snapshot_batch_matches_jax_stepper():
    jc, cw, intr = jax_frames(96, 48, 16, 32, 1.5, seed=11)
    budgets = (1, 2, 4, 8)
    want = jax_snapshots(jc, intr, cw, budgets, nm=8)
    code = from_jax_code(jc)
    g = DeviceGraph.from_code(code)
    init_fn, step_fn = make_layered_stepper(g, 8, 0.3, "ems", "pallas")
    mc = MonteCarlo(code, SimConfig(ebn0_db=1.5), device="cpu")
    got = snapshot_batch(init_fn, step_fn, torch.from_numpy(intr),
                         torch.from_numpy(cw), budgets, mc.count)
    assert got == want
    fe = [want[0][b] for b in budgets]
    assert fe[0] > fe[-1] > 0        # informative: errors fall with budget


def test_run_snapshots_equals_host_loop_run():
    code = random_regular(96, 48, 16, seed=0)
    cfg = SimConfig(ebn0_db=2.0, frames_per_batch=32, max_frames=64,
                    stop_errors=10**9,
                    decoder=DecoderConfig(loop="host", **EMS))
    snap = run_snapshots(code, cfg, budgets=(2, 5, 10), batches=2,
                         device="cpu")
    run = MonteCarlo(code, cfg, device="cpu").run()
    assert snap.frames == run.frames == 64
    assert (snap.frame_errors[10], snap.bit_errors[10]) == (
        run.frame_errors, run.bit_errors)
    fers = [snap.fer(b) for b in (2, 5, 10)]
    assert fers[0] >= fers[1] >= fers[2] > 0
    assert snap.ber(10, code.k * code.logq) == run.ber


def test_fake_bch_rule():
    """The fake-BCH filter can only lower the counted frame errors."""
    code = random_regular(96, 48, 16, seed=0)
    dec = DecoderConfig(**dict(EMS, max_iters=6))
    base = dict(ebn0_db=1.5, frames_per_batch=64, encode="zero", decoder=dec)
    r0 = run_snapshots(code, SimConfig(**base), budgets=(6,), device="cpu")
    r12 = run_snapshots(code, SimConfig(**base, fake_bch_t=12), budgets=(6,),
                        device="cpu")
    assert r12.frame_errors[6] < r0.frame_errors[6]
    assert r12.bit_errors[6] == r0.bit_errors[6]


@pytest.mark.parametrize("loop", ["device", "host"])
@pytest.mark.parametrize("cn", ["ems", "spa"])
def test_twophase_matches_singlephase(cn, loop):
    code = random_regular(96, 48, 16, seed=0)
    dec = (dict(EMS) if cn == "ems"
           else dict(max_iters=10, schedule="layered", cn="spa"))
    cfg = SimConfig(ebn0_db=2.0, frames_per_batch=64, max_frames=128,
                    stop_errors=10**9,
                    decoder=DecoderConfig(loop=loop, **dec))
    one = MonteCarlo(code, cfg, device="cpu").run()
    device_loop.captures = 0
    two = run_twophase(code, cfg, phase_a_iters=2, device="cpu")
    fields = ("frames", "frame_errors", "bit_errors", "undetected_errors",
              "iter_sum")
    assert [getattr(two, k) for k in fields] == [getattr(one, k)
                                                 for k in fields]
    assert 0 < one.frame_errors < one.frames
    # phase A's 2 steps, then every retry's, in each of the 2 batches
    assert one.decoder_steps <= two.decoder_steps
    assert device_loop.captures == 0          # no graph on the CPU


@pytest.mark.cuda
def test_stats_and_snapshots_on_card():
    """decode_flooding_stats and run_snapshots on the card (K1) against the
    CPU (its plain version) on 16 frames drawn on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    code = random_regular(96, 48, 16, seed=0)
    cfg = SimConfig(ebn0_db=1.5, frames_per_batch=16,
                    decoder=DecoderConfig(**EMS))
    mc = MonteCarlo(code, cfg, device="cuda")
    cw, intr = mc.gen(0)
    g = mc.graph
    card = decode_flooding_stats(g, intr, 10, 8, 0.3, "ems", "pallas")
    cpu = decode_flooding_stats(g, intr.cpu(), 10, 8, 0.3, "ems", "pallas")
    for name in ("conv_by_iter", "iters", "rank_hist"):
        np.testing.assert_array_equal(getattr(card, name), getattr(cpu, name))
    want = decode_flooding_hostloop(g, intr.cpu(), 10, 8, 0.3, "ems",
                                    "pallas")
    np.testing.assert_array_equal(card.iters, want[1].numpy())
    snap = run_snapshots(code, cfg, budgets=(2, 5, 10), device="cuda")
    init_fn, step_fn = make_layered_stepper(g, 8, 0.3, "ems", "pallas")
    cpu_mc = MonteCarlo(code, cfg, device="cpu")
    fe, be = snapshot_batch(init_fn, step_fn, intr.cpu(), cw.cpu(),
                            (2, 5, 10), cpu_mc.count)
    assert snap.frame_errors == fe and snap.bit_errors == be
