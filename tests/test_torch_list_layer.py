"""The layered truncated-list EMS super-layer step: ``cuda_list.list_layer``
(K3) and its plain version ``listcn.list_layer_plain``, against the JAX
package's sweep body and against the port's sweep as it ran before the
kernel; its place in the sweep, its route choice, its guards and its
shared-memory layout.

On a CPU tensor ``list_layer`` runs ``list_layer_plain``.  Inputs are
made from seeded numpy generators.  Tolerance: none.
* At an f32 state every step of the list sweep is exact in both packages
  (single f32 adds and subtractions, selections of unique packed keys,
  integer GF logic), so the plain step equals JAX's
  ``_make_list_iteration_unrolled`` bit for bit.
* The plain step is the former sweep body moved, so it equals that body
  (kept here as ``pre_kernel_layer``) bit for bit at f32 and at bf16.
* Both write their padded slots into the padding column N and edge E
  (several slots, one element: which value lands is unspecified), so
  those are left out of every comparison, as in
  ``tests/test_torch_bubble_layer.py``; the kernel writes nothing there.
States are decoder-like: compressed CtoV lists of integer levels ("ties",
so that equal values and repeated GF ids are common) or of continuous
values ("decoder"), with unfilled tails at the saturation, and the states
the sweep itself makes after two steps.

Only the comparison with JAX imports the JAX package (inside the test),
so the card-only test is collected where JAX is absent.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ems_nbldpc_torch.decoder import device_loop, layered
from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.flooding import host_loop
from ems_nbldpc_torch.decoder.graph import DeviceGraph
from ems_nbldpc_torch.models.code import from_parsed
from ems_nbldpc_torch.models.formats import ParsedMatrix
from ems_nbldpc_torch.ops import cuda_list, listcn
from ems_nbldpc_torch.ops.minconv import topk_message

OFFSET = 0.3
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: under the tier-1 run's workers, torch's
    per-core threads on these small tensors cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def regular_rows(n, m, dc, rng):
    """m rows of degree dc over n columns of equal degree m dc / n: a
    configuration model whose repeated columns within a row are repaired
    by swapping sockets with other rows.  The port's ``random_regular``
    draws fresh shuffles instead, which never succeed at high dc (it must
    draw as JAX's does, so it stays as it is)."""
    sockets = np.repeat(np.arange(n), m * dc // n)
    rng.shuffle(sockets)
    rows = sockets.reshape(m, dc).copy()
    for _ in range(100 * m * dc):
        dup = [(r, k) for r in range(m) for k in range(dc)
               if (rows[r] == rows[r, k]).sum() > 1]
        if not dup:
            return [np.sort(r) for r in rows]
        r, k = dup[rng.integers(len(dup))]
        s, j = rng.integers(m), rng.integers(dc)
        if s != r and rows[s, j] not in rows[r] and rows[r, k] not in rows[s]:
            rows[r, k], rows[s, j] = rows[s, j], rows[r, k]
    raise RuntimeError("edge swaps did not repair the rows")


def make_codes(kind, q, dc, seed=0):
    """(the parsed matrix, the port's graph of its code): "regular"
    (column degree 2, ``regular_rows``) or "irregular" (row degrees 2..dc,
    the first dc), whose layers carry padded slots."""
    rng = np.random.default_rng(seed)
    if kind == "regular":
        n, m = 4 * dc, 8
        rows = regular_rows(n, m, dc, rng)
    else:
        n, m = 16, 8
        degs = [dc] + list(rng.integers(2, dc + 1, m - 1))
        rows = [np.sort(rng.choice(n, d, replace=False)) for d in degs]
    coefs = [rng.integers(1, q, len(r)) for r in rows]
    parsed = ParsedMatrix(n, m, q, rows, coefs)
    return parsed, DeviceGraph.from_code(from_parsed(parsed))


def list_state(g, f, nm, kind, seed, dtype=torch.float32):
    """A decoder-like compressed state (APP [F, N+1, q], cv_v [F, E+1, nm],
    cv_g uint8, cv_sat [F, E+1]) and active [F] with frames 1 and F-1
    frozen.  CtoV lists ascending from 0 ("ties": levels 0..5, else
    0..10), ids drawn with repeats, about a third with an unfilled tail at
    the saturation, sat = last + offset; APP = X + every edge's expanded
    CtoV (X one low-cost symbol a column and the rest 2..40, or levels
    0..5); the padding column and edge as a decoder holds them."""
    rng = np.random.default_rng(seed)
    q, n, e = g.q, g.code.n, g.n_edges
    if kind == "ties":
        x = rng.integers(0, 6, (f, n + 1, q)).astype(np.float32)
        cv_v = rng.integers(0, 6, (f, e + 1, nm)).astype(np.float32)
    else:
        x = (2 + 38 * rng.random((f, n + 1, q))).astype(np.float32)
        best = rng.integers(0, q, (f, n + 1, 1))
        np.put_along_axis(x, best, rng.random((f, n + 1, 1)).astype(
            np.float32), -1)
        cv_v = (10 * rng.random((f, e + 1, nm))).astype(np.float32)
    cv_v = np.sort(cv_v, -1)
    cv_v -= cv_v[..., :1]
    sat = cv_v[..., -1] + np.float32(OFFSET)
    tail = rng.random((f, e + 1)) < 1 / 3
    sat[tail] = cv_v[tail, nm // 2 - 1] + np.float32(OFFSET)
    cv_v[tail, nm // 2:] = sat[tail, None]
    cv_g = rng.integers(0, q, (f, e + 1, nm)).astype(np.uint8)
    cv_v[:, e], sat[:, e], x[:, n] = 0, 0, 0
    cv_g[:, e] = np.arange(nm)
    cv_v, cv_g, sat = (torch.from_numpy(a) for a in (cv_v, cv_g, sat))
    app = torch.from_numpy(x)
    ctov = listcn.expand_list(cv_v[:, :e], cv_g[:, :e], sat[:, :e], q)
    app[:, :n].index_add_(1, torch.as_tensor(g.code.edge_col,
                                             dtype=torch.int64), ctov)
    active = torch.ones(f, dtype=torch.bool)
    active[1] = active[-1] = False
    return (app.to(dtype), cv_v.to(dtype), cv_g, sat.to(dtype)), active


def decoded_state(g, f, nm, nboper, dtype, seed, steps=2):
    """The state the sweep makes after ``steps`` steps from a
    decoder-like intrinsic, with frames 1 and F-1 frozen afterwards."""
    rng = np.random.default_rng(seed)
    x = (2 + 20 * rng.random((f, g.code.n, g.q))).astype(np.float32)
    x[..., 0] = rng.random((f, g.code.n))          # the all-zero word leads
    init, step = layered.make_layered_list_stepper(g, nm, OFFSET, nboper,
                                                   dtype)
    state = init(torch.from_numpy(x - x.min(-1, keepdims=True)))
    for _ in range(steps):
        state = step(state)
    active = torch.ones(f, dtype=torch.bool)
    active[1] = active[-1] = False
    return tuple(s.clone() for s in state[:4]), active


def layer_args(p):
    return (p["cols32"], p["edge_ids32"], p["rc_in"], p["rc_out"],
            p["valid"])


def pre_kernel_layer(app, cv_v, cv_g, cv_sat, active, p, nm, nboper,
                     offset):
    """The layered list sweep's body as it ran before K3
    (``layered._make_list_iteration``'s ``one_iteration``, one plan)."""
    q = app.shape[-1]
    truncate = listcn.topk_list if nboper > 0 else topk_message
    keep = ~active[:, None, None]
    edge_ids, cols = p["edge_ids"], p["cols"]
    app_rows = app[:, cols]
    cvv_rows = cv_v[:, edge_ids]
    cvg_rows = cv_g[:, edge_ids]
    sat_rows = cv_sat[:, edge_ids]
    ctov_rows = listcn.expand_list(
        cvv_rows.float(), cvg_rows, sat_rows.float(), q, app.dtype)
    mvc = app_rows - ctov_rows
    mvc = mvc - mvc.min(dim=-1, keepdim=True).values
    bv, bg = truncate(mvc.float(), nm)
    bgr = listcn.rotate_ids(bg.to(torch.int32), p["rc_in"][None])
    if p["valid"] is not None:
        nv, ng = listcn.neutral_list(bv.shape[:-1], nm, device=bv.device)
        lane = p["valid"][None, ..., None]
        bv = torch.where(lane, bv, nv)
        bgr = torch.where(lane, bgr, ng)
    ov, ogr = listcn.fb_checknode_list(bv, bgr, nm, nboper)
    og = listcn.rotate_ids(ogr, p["rc_out"][None])
    ov, sat = listcn.saturate_list(ov, offset)
    dense = listcn.expand_list(ov, og, sat, q, app.dtype)
    cv_v[:, edge_ids] = torch.where(keep[..., None], cvv_rows,
                                    ov.to(cv_v.dtype))
    cv_g[:, edge_ids] = torch.where(keep[..., None], cvg_rows,
                                    og.to(cv_g.dtype))
    cv_sat[:, edge_ids] = torch.where(keep, sat_rows, sat.to(cv_sat.dtype))
    app[:, cols] = torch.where(keep[..., None], app_rows,
                               (mvc + dense).to(app.dtype))


def bits(a):
    """numpy view of a state tensor's bits (f32 as int32, bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == BF16 else a
        a = a.numpy()
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same(got, want):
    """Bit for bit but the padding column and edge (the last row of each
    state tensor)."""
    for name, a, b in zip(("app", "cv_v", "cv_g", "cv_sat"), got, want):
        np.testing.assert_array_equal(bits(a)[:, :-1], bits(b)[:, :-1],
                                      err_msg=name)


def assert_frozen_kept(got, before, active):
    for a, x in zip(got, before):
        assert torch.equal(a[~active], x[~active])


# (code kind, q, dc, nm, nboper, state kind)
JAX_CASES = [
    ("regular", 16, 4, 8, 16, "ties"),
    ("irregular", 16, 5, 8, 16, "decoder"),
    ("regular", 64, 4, 32, 64, "decoder"),
    ("irregular", 64, 4, 32, 64, "ties"),
    ("regular", 64, 4, 25, 24, "ties"),
    ("irregular", 64, 5, 25, 24, "decoder"),
    ("regular", 64, 20, 8, 16, "ties"),         # dc = 20, the Ahmed shape
    ("regular", 64, 4, 32, 0, "ties"),          # the exact mode
    ("irregular", 16, 5, 8, 0, "decoder"),
]


@pytest.mark.parametrize("kind,q,dc,nm,nboper,state_kind", JAX_CASES)
def test_plain_step_matches_jax_sweep(kind, q, dc, nm, nboper, state_kind):
    """One list sweep (every super-layer) of ``list_layer_plain`` against
    JAX's sweep body (jitted, as its decoders run it) on the same f32
    state, frozen frames included."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from ems_nbldpc_tpu.decoder.graph import DeviceGraph as JGraph
    from ems_nbldpc_tpu.decoder.layered import _layer_plan as jlayer_plan
    from ems_nbldpc_tpu.decoder.layered import \
        _make_list_iteration_unrolled as jlist_iteration
    from ems_nbldpc_tpu.models.code import from_parsed as jfrom_parsed
    from ems_nbldpc_tpu.models.formats import ParsedMatrix as JParsedMatrix

    parsed, g = make_codes(kind, q, dc, seed=dc + nm)
    plans = layered._layer_plan(g, "cpu")
    assert (kind == "irregular") == any(p["valid"] is not None
                                        for p in plans)
    state, active = list_state(g, 4, nm, state_kind, seed=q + nm + dc)
    jg = JGraph.from_code(jfrom_parsed(JParsedMatrix(
        parsed.n, parsed.m, parsed.q, parsed.row_cols,
        parsed.row_coefs_poly)))
    # the same code, coloured into the same super-layers in both packages
    for p, jp in zip(plans, jlayer_plan(jg), strict=True):
        assert np.array_equal(p["cols"].numpy(), np.asarray(jp["cols"]))
    sweep = jax.jit(jlist_iteration(jg, jlayer_plan(jg), nm, OFFSET,
                                    nboper))
    want = sweep(*(jnp.asarray(s.numpy()) for s in state),
                 jnp.asarray(active.numpy()))
    got = [s.clone() for s in state]
    for p in plans:
        listcn.list_layer_plain(*got, active, *layer_args(p), nm, nboper,
                                OFFSET)
    assert_same(got, want)
    assert_frozen_kept(got, state, active)
    assert not torch.equal(got[0][active], state[0][active])


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("kind,q,dc,nm,nboper", [
    ("regular", 16, 4, 8, 16),
    ("irregular", 16, 6, 8, 16),
    ("regular", 64, 4, 32, 64),
    ("irregular", 64, 5, 25, 24),
    ("regular", 64, 20, 32, 64),
    ("irregular", 16, 4, 8, 0),                 # the exact mode
])
def test_list_layer_matches_pre_kernel_sweep(kind, q, dc, nm, nboper,
                                             dtype):
    """``list_layer`` (on CPU tensors: the plain version; the exact mode
    through ``list_layer_plain`` itself) against the sweep body before the
    kernel, layer by layer, from random and decoded states at f32 and
    bf16; no kernel launch is counted."""
    _, g = make_codes(kind, q, dc, seed=3 * dc + nm)
    step = listcn.list_layer_plain if nboper == 0 else cuda_list.list_layer
    before = cuda_list.launches
    states = [list_state(g, 5, nm, k, seed=dc + i, dtype=dtype)
              for i, k in enumerate(("ties", "decoder"))]
    states.append(decoded_state(g, 5, nm, nboper, dtype, seed=dc))
    for state, active in states:
        for p in layered._layer_plan(g, "cpu"):
            got = [s.clone() for s in state]
            want = [s.clone() for s in state]
            step(*got, active, *layer_args(p), nm, nboper, OFFSET)
            pre_kernel_layer(*want, active, p, nm, nboper, OFFSET)
            assert_same(got, want)
            assert_frozen_kept(got, state, active)
    assert cuda_list.launches == before


def bpsk_intrinsic(g, f, ebn0, seed):
    """Intrinsic costs [F, N, q] of the all-zero codeword over BPSK + AWGN
    (rate 1/2 noise), from a numpy generator."""
    rng = np.random.default_rng(seed)
    m = g.q.bit_length() - 1
    sigma = np.sqrt(1 / (2 * 0.5 * 10 ** (ebn0 / 10)))
    y = 1 + sigma * rng.standard_normal((f, g.code.n, m))
    bits = (np.arange(g.q)[:, None] >> np.arange(m)) & 1        # [q, m]
    cost = (2 * y / sigma ** 2) @ bits.T                       # [F, N, q]
    return torch.from_numpy((cost - cost.min(-1, keepdims=True)).astype(
        np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["regular", "irregular"])
def test_decode_unchanged_under_both_loops(kind, dtype):
    """``decode(storage="compressed", nboper=64)`` under the host and the
    device loop gives the decisions, iterations and convergence of the
    sweep before the kernel."""
    q, dc, nm = 16, 4, 8
    _, g = make_codes(kind, q, dc, seed=11)
    intr = bpsk_intrinsic(g, 24, 1.0, seed=5)
    torch_dtype = getattr(torch, dtype)

    def old_iteration(app, cv_v, cv_g, cv_sat, active):
        for p in layered._layer_plan(g, "cpu"):
            pre_kernel_layer(app, cv_v, cv_g, cv_sat, active, p, nm, 64,
                             OFFSET)

    want = host_loop(*layered._compressed_stepper(g, nm, torch_dtype,
                                                  old_iteration),
                     intr.to(torch_dtype), 10)
    assert int(want[1].max()) > 1 and bool(want[2].any())   # informative
    cfg = DecoderConfig(max_iters=10, schedule="layered", cn="ems", nm=nm,
                        offset=OFFSET, nboper=64, storage="compressed",
                        dtype=dtype)
    for loop in ("host", "device"):
        got = decode(g, intr, dataclasses.replace(cfg, loop=loop))
        for a, b in zip(got, want):
            assert torch.equal(a, b), loop


@pytest.mark.parametrize("nm,nboper,dc", [
    (8, 64, 4), (8, 0, 4), (65, 64, 4), (8, 64, 20)])
def test_route_is_chosen_when_the_stepper_is_built(monkeypatch, nm, nboper,
                                                   dc):
    """One ``list_layer`` call per super-layer for every configuration:
    the staircase at nm <= 64, the exact nboper = 0 mode and nm > 64 (K3
    takes them all on the card); the wrapper runs the plain version on CPU
    tensors, and nothing calls ``list_layer_plain`` directly.  The step
    the stepper runs does not depend on the device; ``plain`` alone takes
    the plain version."""
    q = 256 if nm > 64 else 16
    _, g = make_codes("regular", q, dc, seed=1)
    calls = {"list_layer": 0, "list_layer_plain": 0}

    def counting(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(cuda_list, "list_layer",
                        counting("list_layer", cuda_list.list_layer))
    monkeypatch.setattr(listcn, "list_layer_plain",
                        counting("list_layer_plain", listcn.list_layer_plain))
    init, step = layered.make_layered_list_stepper(g, nm, OFFSET, nboper,
                                                   torch.float32)
    assert sum(calls.values()) == 0
    step(init(bpsk_intrinsic(g, 2, 1.0, seed=0)))
    layers = len(g.layers)
    # the wrapper runs the plain version on CPU tensors, unpatched
    assert calls == {"list_layer": layers, "list_layer_plain": 0}
    assert cuda_list.takes(dc, q, nm)
    assert layered._list_layer_step(plain=True) is listcn.list_layer_plain
    assert layered._list_layer_step() is cuda_list.list_layer


def test_device_loop_restores_the_list_count():
    """The device loop restores ``cuda_list.launches`` after a capture."""
    assert device_loop._COUNTERS["list_layer"] == (cuda_list, "launches")
    assert "list_layer" in device_loop.launch_counts()


def test_shared_memory_layout_mirrors_the_source():
    """The staircase's candidates (``staircase_pairs`` mirrors its
    namesake in csrc/list_checknode.cu; chip_smoke.py's bounds read it) and
    the shapes K3 takes at the limits' corners.  The library lays out its
    shared memory and picks its path itself."""
    assert cuda_list.staircase_pairs(32, 64) == 216
    assert cuda_list.staircase_pairs(25, 24) == sum(
        min(25, 24 // (i + 1)) for i in range(25))
    assert cuda_list.staircase_pairs(64, 4096) == 64 * 64
    assert cuda_list.takes(20, 256, 64)
    assert cuda_list.takes(1, 16, 16) and cuda_list.takes(2, 2, 2)
    # the general step: nm > 64, rows past a block's shared memory (from
    # the workspace); the library picks the path (chip_smoke.py 3f, 3g)
    assert cuda_list.takes(4, 256, 65)
    assert cuda_list.takes(4, 256, 256)
    assert not cuda_list.takes(4, 48, 8)
    assert cuda_list.takes(400, 256, 64)
    assert not cuda_list.takes(4, 16, 17)          # nm > q


def _pr14_warps(dc, q, nm, nboper):
    """Warps a block of the kernel's former layout: mvc in f32, the lists
    as f32 values and uint8 ids, one 256-entry table."""
    if (q < 2 or q > 256 or q & (q - 1) or not 1 <= nm <= min(q, 64)
            or nboper < 1 or dc < 1):
        return 0
    def a16(b):
        return (b + 15) // 16 * 16
    lists = dc if dc <= 2 else 3 * dc - 4
    wb = a16(4 * dc * q) + a16(4 * lists * nm) + a16(lists * nm) + 1024
    room = 232448 - a16(2 * cuda_list.staircase_pairs(nm, nboper))
    return max(0, min(4, room // wb))


def test_taken_shapes_keep_the_former_limits():
    """Every shape the former layout took is still taken, and so is every
    shape the plain version takes (q a power of two <= 256, 1 <= nm <= q)
    for every nboper.  Which of K3's steps runs a shape is the library's
    choice (``cuda_list.path``; chip_smoke.py 3f holds the bench row and
    the odd staircase layers on the fast step)."""
    grid = [(dc, q, nm, ops) for dc in (1, 2, 3, 4, 5, 6, 20, 40, 100, 400)
            for q in (2, 16, 48, 64, 256, 512)
            for nm in (1, 4, 8, 12, 25, 32, 64, 65)
            for ops in (0, 1, 4, 24, 64, 4096)]
    former = [k for k in grid if _pr14_warps(*k) > 0]
    assert len(former) > 100
    assert all(cuda_list.takes(*k[:3]) for k in former)
    assert all(cuda_list.takes(*k[:3]) == (q in (2, 16, 64, 256) and nm <= q)
               for k in grid for q, nm in [k[1:3]])


# ---- a model of K3's selection (select_nm in csrc/list_checknode.cu) ----
#
# The warp's 256 keys as a [32 lanes, 8 registers] array, a warp shuffle as
# a permutation of the lanes: the same steps on the same positions as the
# kernel, held against a sort.

_NET8 = [(0, 2), (1, 3), (4, 6), (5, 7), (0, 4), (1, 5), (2, 6), (3, 7),
         (0, 1), (2, 3), (4, 5), (6, 7), (2, 4), (3, 5), (1, 4), (3, 6),
         (1, 2), (3, 4), (5, 6)]
_LANE = np.arange(32)
_DUP = 0x7FFFFFFF


def _cx(k, i, j):
    lo, hi = np.minimum(k[:, i], k[:, j]), np.maximum(k[:, i], k[:, j])
    k[:, i], k[:, j] = lo, hi


def _cx_lane(k, o, upper):
    return np.where(upper[:, None], np.maximum(k, o), np.minimum(k, o))


def _half_clean(k, r, run):
    s = run >> 1
    while s > 0:
        if s >= r:
            d = s // r
            k = _cx_lane(k, k[_LANE ^ d], (_LANE & d) != 0)
        else:
            for i in range(r):
                if not i & s:
                    _cx(k, i, i | s)
        s >>= 1
    return k


def _sort_runs(k, r, run):
    size = 2 * r
    while size <= run:
        o = k[_LANE ^ ((size - 1) // r)][:, ::-1]
        k = _half_clean(_cx_lane(k, o, (_LANE & (size // (2 * r))) != 0),
                        r, size >> 1)
        size <<= 1
    return k


def _halve(k, r, lanes, run):
    r2, upper = r // 2, (_LANE & lanes) != 0
    c = np.empty((32, r2), dtype=k.dtype)
    for i in range(r2):
        o = np.where(upper, k[:, r - 1 - i], k[:, r2 + i])[_LANE ^ (2 * lanes
                                                                    - 1)]
        c[:, i] = np.where(upper, np.minimum(o, k[:, r2 - 1 - i]),
                           np.minimum(k[:, i], o))
    nlo = _LANE & (2 * lanes - 1)
    src = (_LANE & ~(2 * lanes - 1)) + np.where(
        nlo & 1, lanes + ((nlo >> 1) ^ (lanes - 1)), nlo >> 1)
    return _half_clean(c[src], r2, run)


def _top64(k):
    """top64 on lanes whose keys ascend: the 64 smallest, ascending."""
    k = _sort_runs(k, 8, 64)
    return _halve(_halve(k, 8, 8, 64), 4, 16, 64).reshape(-1)


def _insert_rest(k, w, nm):
    """insert_rest: while a lane's next key (its 5th, 6th, ...) lies below
    the nm-th of w, insert it into w (the last drops); returns (w, the
    number of keys inserted)."""
    nxt, used, n = k[:, 4].copy(), np.full(32, 4), 0
    while (nxt < w[nm - 1]).any():
        src = int(np.flatnonzero(nxt < w[nm - 1])[0])
        x = nxt[src]
        below = np.concatenate([w[:1], w[:-1]])
        w = np.where(w < x, w, np.where((_LANE == 0) | (below < x), x, below))
        used[src] += 1
        nxt[src] = k[src, used[src]] if used[src] < 8 else 0xFFFFFFFF
        n += 1
    return w, n


def select_model(keys, nm):
    """(the nm smallest of 256 keys by K3's steps, the keys inserted after
    the 128-key fast path): keys [256] in the kernel's symbol order
    sym(lane, i) = 128 (i / 4) + 4 lane + i % 4."""
    sym = np.array([128 * (i >> 2) + 4 * lane + (i & 3) for lane in range(32)
                    for i in range(8)])
    k = keys[sym].reshape(32, 8).copy()
    for i, j in _NET8:                      # sort8: each lane ascending
        _cx(k, i, j)
    if nm > 32:                             # select_slow: all 256 keys
        return _top64(k)[:nm], 0
    w = _sort_runs(k[:, :4].copy(), 4, 32)  # top_fast: the lanes' 4 smallest
    w = _halve(_halve(w, 4, 8, 32), 2, 16, 32)[:, 0]
    w, n = _insert_rest(k, w, nm)
    return w[:nm], n


def _model_keys(kind, nm, rng):
    """256 packed keys (bf16 bits << 8 | id) of one selection: "random"
    values, "ties" (three levels), "flat" (one value: only the ids
    order them), "absent" (fewer present ids than nm, the rest the dup
    marker, as in a merge's table), "one_lane" (the smallest keys in one
    lane's symbols, so that the fast path cannot hold)."""
    ids = np.arange(256, dtype=np.int64)
    vals = {"random": rng.integers(0, 0x4E6E, 256),
            "ties": rng.integers(0x3F80, 0x3F83, 256),
            "flat": np.full(256, 0x4000),
            "absent": rng.integers(0, 0x4E6E, 256),
            "one_lane": rng.integers(0x4000, 0x4E6E, 256)}[kind]
    keys = vals.astype(np.int64) << 8 | ids
    if kind == "absent":
        keys[rng.permutation(256)[rng.integers(0, nm):]] = _DUP
    if kind == "one_lane":
        lane = rng.integers(32)
        for i in range(8):
            s = 128 * (i >> 2) + 4 * lane + (i & 3)
            keys[s] = i << 8 | s
    return keys


@pytest.mark.parametrize("kind", ["random", "ties", "flat", "absent",
                                  "one_lane"])
@pytest.mark.parametrize("nm", [1, 31, 32, 33, 64])
def test_selection_model_equals_a_sort(kind, nm):
    """K3's selection steps (sort8, the 128-key fast path and the keys it
    left out inserted, or past 32 the 256-key runs of 64 and halvings)
    give the nm smallest keys, ascending, on tie-heavy, absent-heavy and
    one-lane inputs; the flat input needs no insertion, the one-lane one
    needs them; the 256-key form is also held alone, at every nm."""
    rng = np.random.default_rng(nm * 7 + len(kind))
    inserted = []
    for _ in range(40):
        keys = _model_keys(kind, nm, rng)
        got, n = select_model(keys, nm)
        np.testing.assert_array_equal(got, np.sort(keys)[:nm])
        inserted.append(n)
        sym = np.array([128 * (i >> 2) + 4 * lane + (i & 3)
                        for lane in range(32) for i in range(8)])
        k = np.sort(keys[sym].reshape(32, 8), axis=1)
        np.testing.assert_array_equal(_top64(k)[:nm], np.sort(keys)[:nm])
    if kind == "flat" and nm <= 32:
        assert not any(inserted)
    if kind == "one_lane" and 6 <= nm <= 32:
        assert all(inserted)


# ---- the exact mode's selection and merge (list_kernel<ST, true>) ----
#
# An exact key is a value's f32 bits over its GF id (39 bits).  The kernel
# selects on 32-bit keys, the bits less their low 8 over the id, with the
# steps above; reads the chosen values back; and keeps that result unless
# the two orders may differ (within one high part the 32-bit keys order by
# id alone): two chosen neighbours of one high part differ in value, or a
# key of the n-th's high part has another value than the n-th.  Then it
# sorts the 39-bit keys.

_BIG = np.float32(1e9)
_BIG_BITS = int(_BIG.view(np.uint32))
_NONE = 0xFFFFFFFF


def select_exact_model(vals, n, nm):
    """(the n smallest exact keys as (value bits, ids), whether the 32-bit
    selection was kept, its nm-th 32-bit key): vals [256] value bits by GF
    id (uint32; _NONE where absent), n <= nm no more than the present."""
    vals = vals.astype(np.int64)
    ids = np.arange(256)
    keys = np.where(vals != _NONE, (vals & ~0xFF) | ids, _NONE)
    chosen, _ = select_model(keys, nm)
    nth = int(chosen[nm - 1])
    chosen = chosen[:n]
    full, hi = vals[chosen & 0xFF], chosen >> 8
    ok = not np.any((hi[1:] == hi[:-1]) & (full[1:] != full[:-1]))
    if n:
        ok = ok and not np.any((vals >> 8 == hi[-1]) & (vals != full[-1]))
    if ok:
        return (full, chosen & 0xFF), True, nth
    exact = np.sort(np.where(vals != _NONE, vals << 8 | ids, 1 << 62))[:n]
    return (exact >> 8, exact & 0xFF), False, nth


def _staircase_mask(nm):
    """The exact merge's first pass: {(i+1)(j+1) <= 2 nm}."""
    i, j = np.meshgrid(np.arange(nm), np.arange(nm), indexing="ij")
    return (i + 1) * (j + 1) <= 2 * nm


def merge_exact_model(av, ag, bv, bg, nm):
    """K3's exact merge (merge_exact) on one pair of ascending lists of nm
    (f32 values, GF ids): the per-GF minima of the staircase's sums, a
    selection, then the candidates outside the staircase whose sum is at
    most the nm-th's bound (row by row, each row stopping at its first sum
    past it), selected again if they lowered a minimum; with fewer than nm
    GF ids below BIG after the first pass, every candidate, and the tail.
    Returns (values, ids, candidates visited after the first pass)."""
    sums = np.minimum(av[:, None] + bv[None, :], _BIG).astype(np.float32)
    sums = sums.view(np.uint32).astype(np.int64)
    gid = (ag[:, None] ^ bg[None, :]) & 0xFF
    first = _staircase_mask(nm)
    tab = np.full(256, _NONE, dtype=np.int64)
    np.minimum.at(tab, gid[first], sums[first])

    def select():
        heads = tab < _BIG_BITS
        n = min(nm, int(heads.sum()))
        return select_exact_model(np.where(heads, tab, _NONE), n, nm) + (n,)

    (vals, ids), _, nth, n = select()
    visited = 0
    if n == nm:
        bound, changed = nth | 0xFF, False
        for i in range(nm):
            for j in range(int(first[i].sum()), nm):
                if sums[i, j] > bound:
                    break
                visited += 1
                changed |= bool(tab[gid[i, j]] > sums[i, j])
                tab[gid[i, j]] = min(tab[gid[i, j]], sums[i, j])
        if changed:
            (vals, ids), _, _, n = select()
    else:
        visited = int((~first).sum())
        np.minimum.at(tab, gid[~first], sums[~first])
        (vals, ids), _, _, n = select()
    out_v = vals.astype(np.uint32).view(np.float32)
    out_g = ids
    if n < nm:
        # the tail: every GF id's candidates but its head, in GF order
        count = np.bincount(gid.reshape(-1), minlength=256)
        left = count - (tab < _BIG_BITS)
        tail = np.repeat(np.arange(256), left)[:nm - n]
        out_v = np.concatenate([out_v, np.full(len(tail), _BIG)])
        out_g = np.concatenate([out_g, tail])
    return out_v, out_g, visited


def _exact_model_values(kind, nm, rng):
    """256 exact value bits by GF id: "random" values, "ties" (three
    levels), "flat" (one value), "absent" (fewer present than nm),
    "one_lane" (the smallest in one lane's symbols; bf16 values, as a
    bf16 state's truncations have), "close" (one high part, differing low
    bits: the 32-bit selection cannot be kept)."""
    v = {"random": 40 * rng.random(256),
         "ties": rng.integers(2, 5, 256) / 2,
         "flat": np.full(256, 2.0),
         "absent": 40 * rng.random(256),
         "one_lane": 3 + 37 * rng.random(256),
         "close": 3 + rng.integers(0, 256, 256) * 2.0 ** -22,
         }[kind].astype(np.float32).view(np.uint32).astype(np.int64)
    if kind == "absent":
        v[rng.permutation(256)[rng.integers(0, nm):]] = _NONE
    if kind == "one_lane":
        v &= 0xFFFF0000
        lane = rng.integers(32)
        for i in range(8):
            v[128 * (i >> 2) + 4 * lane + (i & 3)] = int(
                np.float32(i).view(np.uint32))
    return v


@pytest.mark.parametrize("kind", ["random", "ties", "flat", "absent",
                                  "one_lane", "close"])
@pytest.mark.parametrize("nm", [1, 31, 32, 33, 64])
def test_exact_selection_model_equals_a_sort(kind, nm):
    """The exact mode's selection (32-bit keys by the staircase's steps,
    the chosen values read back and checked, else a sort of the 39-bit
    keys) gives the n smallest (value bits, GF id) keys, ascending; the
    32-bit result is kept on every bf16-valued input and on the random
    ones, never on the "close" ones."""
    rng = np.random.default_rng(nm * 11 + len(kind))
    kept = []
    for _ in range(40):
        v = _exact_model_values(kind, nm, rng)
        n = min(nm, int((v != _NONE).sum()))
        (bits_, ids), ok, _ = select_exact_model(v, n, nm)
        want = np.sort(np.where(v != _NONE, v << 8 | np.arange(256),
                                1 << 62))[:n]
        np.testing.assert_array_equal(bits_ << 8 | ids, want)
        kept.append(ok)
    if kind in ("ties", "flat", "one_lane"):
        assert all(kept)
    if kind == "close" and nm > 1:
        assert not any(kept)


def _exact_model_lists(kind, nm, rng):
    """Two ascending lists of nm (f32 values, GF ids) as K3's merges get
    them: "decoder" (continuous values from 0, distinct ids), "ties"
    (levels 0..5), "few" (3 values below BIG, then BIG with repeated ids:
    fewer than nm GF ids below BIG, the tail), "big" (values from BIG /
    2.5, so that all sums but one clamp at BIG), "neutral" (b the merge's
    identity), "close" (values in one high part: the 32-bit selection
    fails)."""
    def one(k):
        ids = rng.permutation(256)[:nm]
        if k == "decoder":
            v = np.sort(10 * rng.random(nm))
        elif k == "ties":
            v = np.sort(rng.integers(0, 6, nm)).astype(float)
        elif k == "few":
            k = min(3, nm - 1)
            v = np.full(nm, 1e9)
            v[:k] = np.sort(5 * rng.random(k))
            ids[k:] = rng.integers(0, 4, nm - k)
        elif k == "big":
            v = np.sort(6e8 + 1e8 * rng.random(nm))
            v[0] = 4e8
        else:
            v = np.sort(3 + rng.integers(0, 64, nm) * 2.0 ** -22)
        v = v - v[0] if k not in ("few", "big") else v
        return v.astype(np.float32), ids.astype(np.int64)

    av, ag = one("decoder" if kind == "neutral" else kind)
    if kind == "neutral":
        bv = np.full(nm, _BIG, dtype=np.float32)
        bv[0] = 0
        return av, ag, bv, np.arange(nm, dtype=np.int64)
    return (av, ag) + one(kind)


@pytest.mark.parametrize("kind", ["decoder", "ties", "few", "big",
                                  "neutral", "close"])
@pytest.mark.parametrize("nm", [1, 8, 32, 33, 64])
def test_exact_merge_model_matches_jax(kind, nm):
    """The exact merge's model (the staircase first, the candidates past
    it pruned by the nm-th's bound, every candidate and the tail where
    fewer than nm GF ids lie below BIG) equals JAX's ``list_combine(...,
    nboper=0)`` and the port's bit for bit, on seeded lists with ties,
    with few GF ids below BIG and with sums at BIG; on the "decoder" lists
    it visits few candidates past the staircase."""
    jax = pytest.importorskip("jax")
    from ems_nbldpc_tpu.ops.listcn import list_combine as jlist_combine

    rng = np.random.default_rng(nm * 13 + len(kind))
    visits = []
    for _ in range(12):
        av, ag, bv, bg = _exact_model_lists(kind, nm, rng)
        got_v, got_g, visited = merge_exact_model(av, ag, bv, bg, nm)
        visits.append(visited)
        want_v, want_g = jax.jit(jlist_combine, static_argnums=(4, 5))(
            av[None], ag[None].astype(np.int32), bv[None],
            bg[None].astype(np.int32), nm, 0)
        np.testing.assert_array_equal(got_v.view(np.uint32), np.asarray(
            want_v)[0].view(np.uint32))
        np.testing.assert_array_equal(got_g, np.asarray(want_g)[0])
        tv, tg = listcn.list_combine(*(torch.from_numpy(x[None]) for x in (
            av, ag.astype(np.int32), bv, bg.astype(np.int32))), nm, 0)
        np.testing.assert_array_equal(got_v, tv[0].numpy())
        np.testing.assert_array_equal(got_g, tg[0].numpy())
        if kind in ("few", "big") and nm >= 32:
            assert got_v[-1] == _BIG            # the tail, or sums at BIG
    if kind == "decoder" and nm >= 8:
        assert np.mean(visits) < nm


def rejection_case(bad):
    """A small valid list_layer call, then one thing made wrong."""
    _, g = make_codes("irregular", 16, 4, seed=2)
    p = layered._layer_plan(g, "cpu")[0]
    (app, cv_v, cv_g, cv_sat), active = list_state(g, 3, 8, "ties", seed=0)
    args = dict(app=app, cv_v=cv_v, cv_g=cv_g, cv_sat=cv_sat, active=active,
                cols=p["cols32"], edges=p["edge_ids32"], rc_in=p["rc_in"],
                rc_out=p["rc_out"], valid=p["valid"], nm=8, nboper=16,
                offset=OFFSET)
    change = {
        "app_f16": dict(app=app.half()),
        "cv_v_bf16": dict(cv_v=cv_v.to(BF16)),
        "cv_g_int32": dict(cv_g=cv_g.int()),
        "cv_sat_f64": dict(cv_sat=cv_sat.double()),
        "app_2d": dict(app=app[0]),
        "cv_v_nm": dict(cv_v=cv_v[..., :4].contiguous()),
        "cv_g_shape": dict(cv_g=cv_g[:, :-1].contiguous()),
        "active_int": dict(active=active.int()),
        "cols_int64": dict(cols=p["cols"]),
        "edges_shape": dict(edges=p["edge_ids32"][:, :2].contiguous()),
        "rc_in_shape": dict(rc_in=p["rc_in"][..., :2].contiguous()),
        "rc_out_none": dict(rc_out=None),
        "valid_shape": dict(valid=p["valid"][:, :2].contiguous()),
        "app_strided": dict(app=app.transpose(0, 1).contiguous()
                            .transpose(0, 1)),
        "nm_over_q": dict(nm=80, cv_v=torch.zeros(cv_v.shape[:2] + (80,)),
                          cv_g=torch.zeros(cv_g.shape[:2] + (80,),
                                           dtype=torch.uint8)),
        "app_q48": dict(app=app[..., :12].repeat(1, 1, 4)),
        "no_rows": dict(cols=p["cols32"][:0], edges=p["edge_ids32"][:0]),
    }
    if bad is not None:
        args.update(change[bad])
    return args, change


BAD = ["app_f16", "cv_v_bf16", "cv_g_int32", "cv_sat_f64", "app_2d",
       "cv_v_nm", "cv_g_shape", "active_int", "cols_int64", "edges_shape",
       "rc_in_shape", "rc_out_none", "valid_shape", "app_strided",
       "nm_over_q", "app_q48", "no_rows"]


@pytest.mark.parametrize("bad", BAD)
def test_list_layer_rejects_bad_inputs(bad):
    args, _ = rejection_case(bad)
    want = TypeError if bad.split("_")[-1] in (
        "f16", "bf16", "int32", "f64") else ValueError
    with pytest.raises(want):
        cuda_list.list_layer(**args)


def test_rejection_case_is_valid_when_nothing_is_bad():
    args, change = rejection_case(None)
    assert sorted(change) == sorted(BAD)
    cuda_list.list_layer(**args)


@pytest.mark.cuda
def test_list_layer_matches_plain_on_card():
    """K3 against its plain version at small shapes, bit for bit but the
    padding column and edge, at f32 and bf16, on the card (chip_smoke.py
    3f runs the full-size comparison)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for kind, q, dc, nm, nboper in [("regular", 256, 4, 32, 64),
                                    ("irregular", 64, 5, 25, 24),
                                    ("regular", 64, 20, 8, 16)]:
        _, g = make_codes(kind, q, dc, seed=4)
        for dtype in (torch.float32, BF16):
            state, active = list_state(g, 6, nm, "ties", seed=q, dtype=dtype)
            for p in layered._layer_plan(g, "cuda"):
                got = [s.cuda() for s in state]
                want = [s.cuda() for s in state]
                cuda_list.list_layer(*got, active.cuda(), *layer_args(p), nm,
                                     nboper, OFFSET)
                listcn.list_layer_plain(*want, active.cuda(),
                                        *layer_args(p), nm, nboper, OFFSET)
                for a, b, x in zip(got, want, state):
                    assert torch.equal(a[:, :-1], b[:, :-1])
                    assert torch.equal(a[:, -1].cpu(), x[:, -1])
