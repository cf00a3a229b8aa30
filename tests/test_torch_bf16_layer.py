"""Dense bf16 storage: the fused super-layer steps on a bf16 state, the
wrappers' dtype rules, flooding SPA's refusal, Monte-Carlo FER against the
JAX package and the CLI at bf16.

On a CPU tensor ``spa_layer``, ``syndrome_layer`` and ``bubble_layer``
run their plain versions.  A bf16 state is widened to f32 where a step
reads it, the step computes in f32, and each store rounds once to
nearest even; so the step on a bf16 state must equal, bit for bit, the f32
step on the widened state with its result rounded to bf16 (the entries it
does not write round back to themselves).  Frozen frames, the rows the
layer does not own and the padding column and edge must keep their bf16
bits.  States are made from seeded numpy generators; some entries hold
sentinel-derived values as a bf16 state holds them (INF_COST = 1e9 reads
back as 998,244,352, BIG = 1e5 as 99,840) and saturated rows (every
symbol but one at one level), so a step that tested a stored value against
a sentinel would show here.  The kernels' bf16 entries are held against
these plain versions on the card (``chip_smoke.py`` 3b, 3c, 3e).  The two
packages round at different places at bf16 (see
``tests/test_torch_bf16_decode.py``), so Monte-Carlo FER Wilson intervals
of the two must overlap, for layered SPA and layered EMS, as
``tests/test_torch_list.py`` holds the list decode; and the decode through
``cn_impl="pallas"`` (the CUDA kernel's plain version here) is held against
JAX's Pallas kernel itself in interpret mode (2 super-layers, nm = 4, as
``tests/test_torch_layered.py`` runs it) as the other families are in
``tests/test_torch_bf16_decode.py``: decisions of frames both converge.
"""
import dataclasses
import functools
import json

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
from ems_nbldpc_tpu.sim.mc import MonteCarlo as JMonteCarlo
from ems_nbldpc_tpu.sim.mc import SimConfig as JSimConfig

from ems_nbldpc_torch import cli
from ems_nbldpc_torch.decoder import flooding
from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.graph import DeviceGraph
from ems_nbldpc_torch.decoder.layered import _layer_plan
from ems_nbldpc_torch.models import tools
from ems_nbldpc_torch.models.code import (from_jax_code, from_parsed,
                                          random_regular)
from ems_nbldpc_torch.models.formats import ParsedMatrix
from ems_nbldpc_torch.ops import cuda_bubble, cuda_spa, cuda_syndrome
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig
from ems_nbldpc_torch.utils.stats import overlapping

OFFSET = 0.3
BF16 = torch.bfloat16
SENTINELS = (1e9, 1e5)          # ops/minconv.INF, ops/bubble_cn.BIG
FER_FAMILIES = {"spa": dict(cn="spa", nm=0),
                "ems pallas": dict(cn="ems", nm=8, cn_impl="pallas")}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread for these small decodes: the suite runs
    in parallel workers, each of which would otherwise spin a thread per
    core on tiny ops (and CPU reductions then also repeat bit for bit)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_code(kind, q, dc, seed=0):
    """A regular code (dv = 2) of row degree dc, or an irregular one of row
    degrees 3..dc (the first dc) whose layers carry padded slots."""
    if kind == "regular":
        return random_regular(4 * dc, 8, q, dv=2, seed=seed)
    rng = np.random.default_rng(seed)
    degs = [dc] + list(rng.integers(3, dc + 1, 7))
    rows = [np.sort(rng.choice(16, d, replace=False)) for d in degs]
    coefs = [rng.integers(1, q, len(r)) for r in rows]
    return from_parsed(ParsedMatrix(16, len(rows), q, rows, coefs))


def bf16_state(g, plan, f, seed):
    """A decoder-like bf16 state (APP [F, N+1, q], CtoV [F, E+1, q], the
    padding column and edge 0) with sentinel-derived and saturated entries
    on the layer's slots, and active [F] with frames 1 and F-1 frozen."""
    rng = np.random.default_rng(seed)
    q, n, e = g.q, g.code.n, g.n_edges
    app = (2 + 38 * rng.random((f, n + 1, q))).astype(np.float32)
    best = rng.integers(0, q, (f, n + 1))
    np.put_along_axis(app, best[..., None], rng.random((f, n + 1, 1)), -1)
    ctov = (10 * rng.random((f, e + 1, q))).astype(np.float32)
    real = (plan["edge_ids"] < e).numpy()
    cols = plan["cols"].numpy()[real]
    edges = plan["edge_ids"].numpy()[real]
    app[:, cols] += ctov[:, edges]
    # sentinel-derived symbols: on some APP rows, on some CtoV rows, and on
    # both rows of one slot (then mvc holds their bf16 difference)
    for i, v in enumerate(SENTINELS):
        fr = rng.integers(0, f, 3)
        sy = rng.integers(0, q, 3)
        app[fr[0], cols[i % len(cols)], sy[0]] = v
        ctov[fr[1], edges[(i + 1) % len(edges)], sy[1]] = v
        app[fr[2], cols[-1 - i], sy[2]] = v
        ctov[fr[2], edges[-1 - i], sy[2]] = v / 2
    # a saturated CtoV row (every symbol but the best at one level) and an
    # APP row that carries it
    sat = np.full(q, 7.3, np.float32)
    sat[rng.integers(0, q)] = 0.0
    ctov[0, edges[0]] = sat
    app[0, cols[0]] = sat + 1.5
    app[:, n] = 0
    ctov[:, e] = 0
    active = torch.ones(f, dtype=torch.bool)
    active[1] = active[-1] = False
    return (torch.from_numpy(app).to(BF16), torch.from_numpy(ctov).to(BF16),
            active)


def step(cn, plan, q, dc):
    """The fused entry of ``cn`` on ``plan``'s tables: fn(app, ctov,
    active)."""
    tabs = (plan["cols32"], plan["edge_ids32"])
    if cn == "spa":
        return lambda a, c, act: cuda_spa.spa_layer(
            a, c, act, *tabs, plan["coefs"], plan["t_tab"], plan["tinv_tab"])
    rot = (plan["rot_in8"], plan["rot_out8"], plan["valid"])
    if cn == "syndrome":
        args, lists = flooding.syndrome_args(dc, q, 0, OFFSET, None, "cpu")
        return lambda a, c, act: cuda_syndrome.syndrome_layer(
            a, c, act, *tabs, *rot, *args, lists)
    nm = min(q // 2, 12)
    return lambda a, c, act: cuda_bubble.bubble_layer(
        a, c, act, *tabs, *rot, nm, 2 * nm, OFFSET, True, True, cn)


LAYER_CASES = [  # (CN of the fused entry, code kind, q, dc)
    ("spa", "regular", 16, 4),
    ("spa", "irregular", 64, 5),
    ("spa", "regular", 256, 3),
    ("syndrome", "regular", 16, 4),
    ("syndrome", "irregular", 64, 4),
    ("syndrome", "regular", 256, 3),
    ("8", "regular", 16, 4),           # bubble_layer, the 8-bubble
    ("L", "irregular", 64, 5),         # and the L-bubble
    ("8", "irregular", 16, 6),
    ("L", "regular", 256, 3),
]


@pytest.mark.parametrize("cn,kind,q,dc", LAYER_CASES)
def test_layer_plain_bf16_is_rounded_f32(cn, kind, q, dc):
    """(a): every layer of the code, F = 4 (two frames frozen)."""
    code = make_code(kind, q, dc, seed=q + dc)
    g = DeviceGraph.from_code(code)
    plans = _layer_plan(g, "cpu")
    if kind == "irregular":
        assert any(p["valid"] is not None for p in plans)  # padded slots
    for k, plan in enumerate(plans):
        app, ctov, active = bf16_state(g, plan, 4, seed=10 * k + q)
        fn = step(cn, plan, q, code.dc_max)
        got = app.clone(), ctov.clone()
        fn(*got, active)
        want = app.float(), ctov.float()
        fn(*want, active)
        real = (plan["edge_ids"] < g.n_edges).numpy()
        own = {"app": plan["cols"].numpy()[real],
               "ctov": plan["edge_ids"].numpy()[real]}
        for name, x0, a, b in zip(("app", "ctov"), (app, ctov), got, want):
            assert a.dtype == BF16 and b.dtype == torch.float32
            # the whole state: the f32 step on the widened state, rounded
            assert torch.equal(a, b.to(BF16)), (name, k)
            # frozen frames, rows not owned, padding: their bf16 bits
            rest = np.setdiff1d(np.arange(x0.shape[1]), own[name])
            assert torch.equal(a[~active], x0[~active]), (name, k)
            assert torch.equal(a[:, rest], x0[:, rest]), (name, k)
            # and the step wrote the rows it owns in the active frames
            assert not torch.equal(a[active][:, own[name]],
                                   x0[active][:, own[name]]), (name, k)


def layer_call(cn):
    """The fused entry of ``cn`` on a small regular code's first layer:
    fn(app, ctov)."""
    code = make_code("regular", 16, 4)
    g = DeviceGraph.from_code(code)
    plan = _layer_plan(g, "cpu")[0]
    fn = step(cn, plan, 16, 4)
    active = torch.ones(2, dtype=torch.bool)
    shapes = ((2, code.n + 1, 16), (2, g.n_edges + 1, 16))
    return fn, active, shapes


@pytest.mark.parametrize("cn", ["spa", "syndrome", "8"])
@pytest.mark.parametrize("dtypes", [
    (torch.float16, torch.float16), (torch.float64, torch.float64),
    (torch.float32, BF16), (BF16, torch.float32)])
def test_layer_wrapper_dtype_rules(cn, dtypes):
    """(b): f32 and bf16 states run (above and in the decodes); f16, f64
    and mixed APP / CtoV dtypes raise TypeError before any step."""
    fn, active, shapes = layer_call(cn)
    app, ctov = (torch.zeros(s, dtype=d) for s, d in zip(shapes, dtypes))
    with pytest.raises(TypeError, match="float32 or bfloat16|one dtype"):
        fn(app, ctov, active)
    assert not app.any() and not ctov.any()


@pytest.mark.parametrize("cn", ["spa", "syndrome", "8"])
def test_layer_wrapper_takes_bf16(cn):
    """(b): a bf16 state of zeros runs, and the step writes its rows."""
    fn, active, shapes = layer_call(cn)
    app = torch.zeros(shapes[0], dtype=BF16)
    app[..., 1:] = 3.0
    ctov = torch.zeros(shapes[1], dtype=BF16)
    fn(app, ctov, active)
    assert app.dtype == ctov.dtype == BF16
    assert torch.isfinite(app.float()).all() and ctov.float().max() > 0


@pytest.mark.parametrize("name,jax_impl", [("spa", None),
                                           ("ems pallas", "topk")])
def test_dense_bf16_fer_ci_overlaps_jax(name, jax_impl):
    """(d): Monte-Carlo FER of port bf16 and JAX bf16, layered SPA and
    layered EMS (the port's pallas route, JAX's exact topk route)."""
    jc = jrandom_regular(96, 48, 16, seed=0)
    dec = dict(FER_FAMILIES[name], max_iters=10,
               schedule="layered", offset=0.3, loop="host",
               dtype="bfloat16")
    kw = dict(ebn0_db=1.5, frames_per_batch=64, max_frames=128,
              stop_errors=10**9)
    jdec = dict(dec, cn_impl=jax_impl) if jax_impl else dec
    jres = JMonteCarlo(jc, JSimConfig(decoder=JConfig(**jdec), **kw)).run()
    tres = MonteCarlo(from_jax_code(jc),
                      SimConfig(decoder=DecoderConfig(**dec), **kw),
                      device="cpu").run()
    assert tres.frames == jres.frames == 128
    assert 0 < tres.frame_errors < tres.frames        # an informative point
    assert overlapping(tres.frame_errors, tres.frames,
                       jres.frame_errors, jres.frames), (
        tres.fer_ci, jres.fer_ci)
    assert 1 < tres.avg_iters < 10


@pytest.mark.parametrize("schedule", ["layered", "flooding"])
def test_dense_bf16_pallas_decode_matches_jax_interpret(monkeypatch,
                                                        schedule):
    """(c) for ``cn_impl="pallas"``: port bf16 against JAX bf16 (its Pallas
    kernel in interpret mode) and against port f32, on decisions of frames
    both converge, at least half of them on each side."""
    monkeypatch.setattr(
        jpallas, "fb_checknode_pallas",
        functools.partial(jpallas.fb_checknode_pallas, tile=16,
                          interpret=True))
    jc = jrandom_regular(16, 8, 16, seed=0)
    assert len(jc.layers) == 2
    sigma = sigma_for(ChannelSpec(), 2.5, jc.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(0), jnp.zeros((16, 16), jnp.int32),
                        16, sigma)
    intr = np.array(intr)
    cfg = DecoderConfig(max_iters=10, schedule=schedule, cn="ems", nm=4,
                        offset=0.3, cn_impl="pallas", loop="host",
                        dtype="bfloat16")
    want = [np.asarray(x) for x in jdecode(
        jc, jnp.asarray(intr), JConfig(**dataclasses.asdict(cfg)))]
    code = from_jax_code(jc)
    got = [x.numpy() for x in decode(code, torch.from_numpy(intr), cfg)]
    f32 = [x.numpy() for x in decode(code, torch.from_numpy(intr),
                                     dataclasses.replace(cfg,
                                                         dtype="float32"))]
    assert got[1].max() > 1                            # informative
    for other in (want, f32):
        assert got[2].sum() >= 8 and other[2].sum() >= 8
        both = got[2] & other[2]
        np.testing.assert_array_equal(got[0][both], other[0][both])


@pytest.mark.parametrize("loop", ["host", "device"])
def test_flooding_spa_bf16_raises_like_jax(loop):
    """(e): the JAX package's flooding SPA decode fails at bf16 (its fused
    CN returns f32 into the bf16 carry), so the port refuses it."""
    jc = jrandom_regular(24, 12, 16, seed=2)
    cfg = DecoderConfig(max_iters=2, schedule="flooding", cn="spa",
                        loop=loop, dtype="bfloat16")
    intr = np.zeros((2, jc.n, jc.q), np.float32)
    with pytest.raises(TypeError):
        jdecode(jc, jnp.asarray(intr), JConfig(**dataclasses.asdict(cfg)))
    with pytest.raises(ValueError, match="flooding SPA"):
        decode(from_jax_code(jc), torch.from_numpy(intr), cfg)
    # the f32 decode and the other dtypes' refusal stand
    decode(from_jax_code(jc), torch.from_numpy(intr),
           dataclasses.replace(cfg, dtype="float32"))
    with pytest.raises(ValueError, match="dtype"):
        decode(from_jax_code(jc), torch.from_numpy(intr),
               dataclasses.replace(cfg, schedule="layered", dtype="float16"))


def test_cli_dense_bf16(tmp_path):
    """(f): ``--dtype bfloat16`` with dense storage runs through the CLI and
    its results carry the dtype in their config_key."""
    code = random_regular(48, 24, 16, seed=3)
    path = str(tmp_path / "code.txt")
    tools.write_ubs(ParsedMatrix(
        code.n, code.m_rows, code.q,
        [code.row_cols[r, :d] for r, d in enumerate(code.row_deg)],
        [code.row_coefs[r, :d] for r, d in enumerate(code.row_deg)]), path)
    out = tmp_path / "out"
    assert cli.main(["--matrix", path, "--ebn0", "2.0", "--cn", "spa",
                     "--iters", "8", "--batch", "16", "--max-frames", "32",
                     "--dtype", "bfloat16", "--out", str(out), "--device",
                     "cpu", "--quiet"]) == 0
    lines = [json.loads(x) for x in
             (out / "results.jsonl").read_text().splitlines()]
    assert len(lines) == 1
    key = lines[0]["config_key"]
    assert ":dense:bfloat16" in key, key
    assert lines[0]["frames"] == 32
