"""The layered host-loop decoders: the port against the JAX package.

The same intrinsics (from the JAX channel, as numpy) go through JAX
``decode(..., layered, host loop, cn="ems", cn_impl="topk")`` and through
the port with ``cn_impl="pallas"`` (on a CPU tensor: the kernel's plain
version), and likewise for the dense min-conv and compressed-storage
branches.  Decisions, iteration counts and convergence flags must be
identical; the state after one step (APP, CtoV) within rtol 1e-6 (the
state is a sum of f32 terms that XLA may fuse differently; in practice it
comes out equal)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ems_nbldpc_tpu.ops.pallas_cn as jpallas
from ems_nbldpc_tpu.decoder.api import DecoderConfig as JConfig
from ems_nbldpc_tpu.decoder.api import decode as jdecode
from ems_nbldpc_tpu.decoder.graph import DeviceGraph as JGraph
from ems_nbldpc_tpu.decoder.layered import \
    make_layered_stepper as jmake_stepper
from ems_nbldpc_tpu.models.channels import ChannelSpec, bpsk_awgn, sigma_for
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular
from ems_nbldpc_tpu.models.encoder import \
    gaussian_elimination as jgaussian_elimination

from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.graph import DeviceGraph
from ems_nbldpc_torch.decoder.layered import make_layered_stepper
from ems_nbldpc_torch.models.code import from_jax_code


def jax_frames(n, m, q, f, ebn0, seed):
    """A JAX code, codewords (numpy back-substitution) and intrinsics."""
    jc = jrandom_regular(n, m, q, seed=seed)
    enc = jgaussian_elimination(jc)
    info = np.random.default_rng(seed).integers(0, q, (f, jc.k))
    cw = enc.encode_np(info)
    sigma = sigma_for(ChannelSpec(), ebn0, jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(seed), jnp.asarray(cw, jnp.int32),
                        q, sigma)
    return jc, cw, np.array(intr)


CASES = [  # n, m, q, nm, f, Eb/N0
    (96, 48, 16, 8, 32, 1.5),
    (48, 24, 256, 32, 12, 1.0),
]


# the full decode at q = 16; at q = 256 the one-step state test below
# holds the port to the JAX stepper (a q = 256 JAX decode costs ~15 s)
@pytest.mark.parametrize("n,m,q,nm,f,ebn0", CASES[:1])
def test_decode_matches_jax(n, m, q, nm, f, ebn0):
    jc, cw, intr = jax_frames(n, m, q, f, ebn0, seed=n + q)
    jcfg = JConfig(max_iters=10, schedule="layered", cn="ems", nm=nm,
                   offset=0.3, cn_impl="topk", loop="host")
    jd, jit_, jconv = (np.asarray(x) for x in jdecode(jc, jnp.asarray(intr),
                                                      jcfg))
    tc = from_jax_code(jc)
    for impl in ("pallas", "topk", "auto"):
        cfg = DecoderConfig(max_iters=10, schedule="layered", cn="ems",
                            nm=nm, offset=0.3, cn_impl=impl, loop="host")
        d, it, conv = decode(tc, torch.from_numpy(intr), cfg)
        np.testing.assert_array_equal(d.numpy(), jd, err_msg=impl)
        np.testing.assert_array_equal(it.numpy(), jit_, err_msg=impl)
        np.testing.assert_array_equal(conv.numpy(), jconv, err_msg=impl)
    # the case is informative: some frames need several iterations, and
    # converged frames decode to the codeword
    assert jit_.max() > 1
    assert (jd[jconv] == cw[jconv]).all()


@pytest.mark.parametrize("n,m,q,nm,f,ebn0", CASES)
def test_state_after_one_step_matches_jax(n, m, q, nm, f, ebn0):
    jc, _, intr = jax_frames(n, m, q, f, ebn0, seed=n + q + 1)
    jinit, jstep = jmake_stepper(JGraph.from_code(jc), nm, 0.3, "ems", "topk")
    jstate = jstep(jinit(jnp.asarray(intr)))
    tinit, tstep = make_layered_stepper(
        DeviceGraph.from_code(from_jax_code(jc)), nm, 0.3, "ems", "pallas")
    tstate = tstep(tinit(torch.from_numpy(intr)))
    for name, a, b in zip(("app", "ctov", "decide", "conv", "iters"),
                          tstate, jstate):
        b = np.asarray(b)
        if name in ("app", "ctov"):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_decode_matches_jax_pallas_interpret(monkeypatch):
    """The JAX side runs its Pallas kernel itself (interpret mode; its cost
    grows with nm and the number of super-layers, so: 2 layers, nm = 4)."""
    monkeypatch.setattr(
        jpallas, "fb_checknode_pallas",
        functools.partial(jpallas.fb_checknode_pallas, tile=16,
                          interpret=True))
    jc, _, intr = jax_frames(16, 8, 16, 4, 2.0, seed=0)
    assert len(jc.layers) == 2
    jcfg = JConfig(max_iters=3, schedule="layered", cn="ems", nm=4,
                   offset=0.3, cn_impl="pallas", loop="host")
    want = [np.asarray(x) for x in jdecode(jc, jnp.asarray(intr), jcfg)]
    # informative: some frames need several iterations, some converge
    assert want[1].max() > 1 and want[2].any()
    cfg = DecoderConfig(**dataclasses.asdict(jcfg))
    got = decode(from_jax_code(jc), torch.from_numpy(intr), cfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_converged_frames_are_frozen():
    jc, _, intr = jax_frames(96, 48, 16, 16, 1.5, seed=5)
    g = DeviceGraph.from_code(from_jax_code(jc))
    init, step = make_layered_stepper(g, 8, 0.3, "ems", "pallas")
    state = init(torch.from_numpy(intr))
    for _ in range(10):          # step until some, not all, frames converged
        state = step(state)
        conv = state[3].clone()
        if conv.any() and not conv.all():
            break
    assert conv.any() and not conv.all()
    app, ctov, iters = (state[i][conv].clone() for i in (0, 1, 4))
    state = step(state)
    assert torch.equal(state[0][conv], app)
    assert torch.equal(state[1][conv], ctov)
    assert torch.equal(state[4][conv], iters)
    assert (state[4][~conv] > iters.max()).all()


PORTED = [  # branches that raised before the flooding schedule was ported
    dict(schedule="flooding"), dict(storage="compressed", cn_impl="topk"),
    dict(schedule="flooding", cn="spa"),
    # exact min-sum: nm = 0 under auto takes the dense min-conv CN
    dict(cn="minsum", nm=0, cn_impl="auto"),
    dict(cn_impl="dense"), dict(cn_impl="list"), dict(nm=16, cn_impl="auto"),
    # min-sum through the truncated combine (nm = 4, the kernel's plain
    # version against JAX topk)
    dict(cn="minsum"),
]


@pytest.mark.parametrize("change", PORTED)
def test_ported_branches_match_jax(change):
    """Each branch decodes as the JAX package does: identical decisions,
    iterations and convergence (``cn_impl="pallas"`` is the kernel's plain
    version here; JAX runs its exact reference, ``topk``)."""
    jc, _, intr = jax_frames(48, 24, 16, 24, 1.5, seed=6)
    base = dict(max_iters=8, cn="ems", nm=4, cn_impl="pallas", loop="host")
    cfg = dataclasses.replace(DecoderConfig(**base), **change)
    jcfg = JConfig(**dict(dataclasses.asdict(cfg), cn_impl="topk"
                          if cfg.cn_impl == "pallas" else cfg.cn_impl))
    want = [np.asarray(x) for x in jdecode(jc, jnp.asarray(intr), jcfg)]
    assert want[1].max() > 1 and want[2].any()      # informative
    got = decode(from_jax_code(jc), torch.from_numpy(intr), cfg)
    for name, a, b in zip(("decide", "iters", "conv"), got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_topk_decode_matches_jax(dtype):
    """The dense-CN decoder with nm-compressed CtoV storage, f32 and bf16
    state on both sides."""
    jc, _, intr = jax_frames(96, 48, 16, 32, 1.5, seed=8)
    jcfg = JConfig(max_iters=12, schedule="layered", cn="ems", nm=8,
                   offset=0.3, cn_impl="topk", loop="host",
                   storage="compressed", dtype=dtype)
    want = [np.asarray(x) for x in jdecode(jc, jnp.asarray(intr), jcfg)]
    assert want[1].max() > 1 and want[2].any()      # informative
    got = decode(from_jax_code(jc), torch.from_numpy(intr),
                 DecoderConfig(**dataclasses.asdict(jcfg)))
    for name, a, b in zip(("decide", "iters", "conv"), got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("change", [
    dict(cn_impl="lbubble"), dict(cn_impl="bubble"),
    dict(schedule="flooding", cn_impl="bubble"),
    dict(schedule="flooding", cn_impl="lbubble"),
])
def test_bubble_branches_decode_like_jax(change):
    """The exact bubble CNs (once the unported branches above) decode on
    both schedules and both loops: decisions, iteration counts and
    convergence identical to JAX's decode of the same intrinsics."""
    jc, _, intr = jax_frames(24, 12, 16, 8, 1.0, seed=2)
    jcfg = dataclasses.replace(
        JConfig(max_iters=6, cn="ems", nm=6, offset=0.3, nboper=10,
                loop="host"), **change)
    want = [np.asarray(x) for x in jdecode(jc, jnp.asarray(intr), jcfg)]
    assert want[1].max() > 1, "uninformative batch"
    for loop in ("host", "device"):
        cfg = DecoderConfig(**dict(dataclasses.asdict(jcfg), loop=loop))
        got = decode(from_jax_code(jc), torch.from_numpy(intr), cfg)
        for name, a, b in zip(("decide", "iters", "conv"), got, want):
            np.testing.assert_array_equal(a.numpy(), b,
                                          err_msg=f"{name} {loop}")


def test_flooding_compressed_is_rejected():
    """As in JAX: compressed storage exists for the layered schedule only."""
    jc = jrandom_regular(24, 12, 16, seed=2)
    cfg = DecoderConfig(max_iters=2, schedule="flooding", cn="ems", nm=4,
                        cn_impl="topk", loop="host", storage="compressed")
    with pytest.raises(ValueError, match="layered"):
        decode(from_jax_code(jc), torch.zeros((2, jc.n, jc.q)), cfg)
