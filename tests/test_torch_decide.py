"""The layered decoders' decisions: ``ops/cuda_decide.decide_rows`` (K4)
and its plain version ``decide_rows_plain``.

On the CPU: the plain version and the wrapper's CPU route against NumPy's
argmin and the latch of the active frames, on float32 and bfloat16 APPs
with planted ties, infinities, NaNs, rows of one value, -0 beside +0,
frozen frames and the padding column; the wrapper's checks; the layered
decoders' steps and resets, which decide through ``decide_rows`` alone,
and their plain routes, which decide through ``decide_rows_plain`` alone.
On the card (``-m cuda``): the kernel against the plain version bit for
bit, the counts it keeps, and device-loop decodes through it against the
host loop with the plain decisions.  No JAX here: the card tests run
where it is absent.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ems_nbldpc_torch.decoder import device_loop, layered
from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.graph import DeviceGraph
from ems_nbldpc_torch.models.code import random_regular
from ems_nbldpc_torch.ops import cuda_decide
from ems_nbldpc_torch.ops.cuda_decide import decide_rows, decide_rows_plain
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig

BF16 = torch.bfloat16
STALE = -7                      # a latched decision no argmin gives


def app_cases(f, n, q, dtype, seed):
    """APP [f, n + 1, q] of ``dtype``: continuous rows, then rows with
    planted ties at the minimum, of one value, with +-inf, with NaNs, and
    with -0 before +0; the padding column holds -inf at its last symbol
    (a decision that read it would show)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((f, n + 1, q)).astype(np.float32) * 4
    r = rng.integers(0, q, size=(f, n, 3))
    for fr in range(f):
        # ties: a few small integer levels, each at several indices
        a[fr, 0] = rng.integers(0, 3, size=q)
        a[fr, 1] = 2.5                                   # one value
        a[fr, 2] = np.inf
        a[fr, 3, r[fr, 3, 0]] = -np.inf
        a[fr, 3, r[fr, 3, 1]] = -np.inf
        a[fr, 4, r[fr, 4, :2]] = np.nan                  # NaN is the min
        a[fr, 5] = np.abs(a[fr, 5])
        a[fr, 5, q // 2] = 0.0
        a[fr, 5, q // 4] = -0.0                          # equals +0
        a[fr, 6, r[fr, 6, 0]] = np.nan
        a[fr, 6, 0] = -np.inf                            # NaN still wins
        a[fr, 7, :] = np.nan
        for v in range(8, n, 5):                         # more ties
            lo = a[fr, v].min()
            a[fr, v, r[fr, v]] = lo
    a[:, n, -1] = -np.inf
    return torch.from_numpy(a).to(dtype)


def expected(app, stale, active):
    """NumPy's argmin of every row (the first NaN, else the first minimum),
    latched on the active frames."""
    n = stale.shape[1]
    x = app[:, :n].float().numpy()
    want = np.argmin(x, axis=-1).astype(np.int64)
    if active is not None:
        want = np.where(active.numpy()[:, None], want, stale.numpy())
    return torch.from_numpy(want)


@pytest.mark.parametrize("q", [16, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_decide_rows_plain_and_cpu_route(dtype, q):
    """``decide_rows_plain`` and ``decide_rows`` on CPU tensors equal the
    argmin and latch: ties to the lowest index, NaN first, -0 equal to +0,
    frozen frames left as they were, the padding column unread; in place
    (the same tensor back), with and without a mask."""
    f, n = 5, 37
    app = app_cases(f, n, q, dtype, seed=q)
    active = torch.tensor([True, False, True, True, False])
    for fn in (decide_rows_plain, decide_rows):
        for mask in (active, None, torch.zeros(f, dtype=torch.bool)):
            decide = torch.full((f, n), STALE, dtype=torch.int64)
            stale = decide.clone()
            out = fn(app, decide, mask)
            assert out is decide
            assert torch.equal(decide, expected(app, stale, mask))
    # spot checks of the planted rows at the active frame 0
    decide = torch.full((f, n), STALE, dtype=torch.int64)
    decide_rows(app, decide, active)
    x = app[0].float()
    assert decide[0, 0] == int(torch.nonzero(x[0] == x[0].min())[0])
    assert decide[0, 1] == 0 and decide[0, 2] == 0
    assert decide[0, 4] == int(torch.nonzero(x[4].isnan())[0])
    assert decide[0, 5] == q // 4
    assert decide[0, 7] == 0
    assert (decide[1] == STALE).all() and (decide[4] == STALE).all()


@pytest.mark.parametrize("change", ["app dtype", "decide dtype", "app rank",
                                    "frames", "columns", "q", "mask dtype",
                                    "mask shape", "strided"])
def test_decide_rows_checks(change):
    """The wrapper refuses what the kernel does not take, on any device."""
    f, n, q = 3, 10, 16
    app = torch.zeros((f, n + 1, q))
    decide = torch.zeros((f, n), dtype=torch.int64)
    active = torch.ones(f, dtype=torch.bool)
    err = ValueError
    if change == "app dtype":
        app, err = app.double(), TypeError
    elif change == "decide dtype":
        decide, err = decide.int(), TypeError
    elif change == "app rank":
        app = app[0]
    elif change == "frames":
        decide = decide[:2]
    elif change == "columns":
        decide = torch.zeros((f, n + 2), dtype=torch.int64)
    elif change == "q":
        app = torch.zeros((f, n + 1, 12))
    elif change == "mask dtype":
        active = active.to(torch.uint8)
    elif change == "mask shape":
        active = active[:2]
    elif change == "strided":
        app = torch.zeros((f, q, n + 1)).transpose(1, 2)
    with pytest.raises(err):
        decide_rows(app, decide, active)


def small_code(q):
    return random_regular(48, 24, q, seed=1)


def intrinsics(code, ebn0, frames, device, seed=3):
    cfg = SimConfig(ebn0_db=ebn0, frames_per_batch=frames, seed=seed,
                    encode="device")
    return MonteCarlo(code, cfg, device=device).gen(0)[1]


PATHS = {  # name -> (GF, decoder fields, the sweep's kernel)
    "spa": (16, dict(cn="spa", nm=0), "spa_layer"),
    "list": (16, dict(cn="ems", nm=8, nboper=16, storage="compressed"),
             "list_layer"),
    "ems pallas": (64, dict(cn="ems", nm=12, cn_impl="pallas"),
                   "fb_checknode"),
    "compressed topk": (16, dict(cn="ems", nm=8, cn_impl="topk",
                                 storage="compressed"), "fb_checknode"),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_layered_decisions_go_through_decide_rows(monkeypatch, path):
    """Every layered decoder decides through ``decide_rows``: once at the
    reset with no mask, then once a step with the step's active frames.
    Host loop on the CPU."""
    q, fields, _ = PATHS[path]
    code = small_code(q)
    intr = intrinsics(code, 1.0, 6, "cpu")
    calls = []

    def counting(app, decide, active=None):
        calls.append(None if active is None else active.clone())
        return decide_rows(app, decide, active)

    monkeypatch.setattr(layered, "decide_rows", counting)
    got = decode(code, intr, DecoderConfig(max_iters=6, loop="host",
                                           **fields))
    steps = int(got[1].max())
    assert steps > 0 and len(calls) == steps + 1 and calls[0] is None
    assert all(c is not None and c.dtype == torch.bool for c in calls[1:])
    assert int(sum(c.sum() for c in calls[1:])) == int(got[1].sum())
    assert device_loop._COUNTERS["decide_rows"] == (cuda_decide, "launches")


PLAIN_ROUTES = {  # name -> (GF, the host-loop decode given ``plain``)
    "spa": (16, lambda g, x, plain: layered.decode_layered_hostloop(
        g, x, 6, cn="spa", plain=plain)),
    "ems topk": (16, lambda g, x, plain: layered.decode_layered_hostloop(
        g, x, 6, nm=8, offset=0.3, cn="ems", cn_impl="topk", plain=plain)),
    "compressed topk": (16, lambda g, x, plain:
                        layered.decode_layered_compressed(
                            g, x, 6, 8, 0.3, torch.float32, plain=plain)),
    "list": (16, lambda g, x, plain: layered.decode_layered_list_hostloop(
        g, x, 6, 8, 0.3, 16, torch.float32, plain=plain)),
}


@pytest.mark.parametrize("route", sorted(PLAIN_ROUTES))
def test_plain_route_decides_without_k4(monkeypatch, route):
    """The layered decoders' plain route (``plain=True``, the card's
    reference for the kernels) decides through ``decide_rows_plain`` at
    the reset and every step, never through ``decide_rows``, and gives the
    decode of the kernel route (on the CPU, where both are torch)."""
    q, run = PLAIN_ROUTES[route]
    code = small_code(q)
    graph = DeviceGraph.from_code(code)
    intr = intrinsics(code, 1.0, 6, "cpu")
    want = run(graph, intr, False)
    calls = []

    def refuse(*args):
        raise AssertionError("the plain route called decide_rows")

    def counting(app, decide, active=None):
        calls.append(active)
        return decide_rows_plain(app, decide, active)

    monkeypatch.setattr(layered, "decide_rows", refuse)
    monkeypatch.setattr(layered, "decide_rows_plain", counting)
    got = run(graph, intr, True)
    steps = int(got[1].max())
    assert steps > 0 and len(calls) == steps + 1 and calls[0] is None
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("q", [16, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_kernel_equals_plain_on_card(dtype, q):
    """K4 against ``decide_rows_plain`` on the card, bit for bit: every
    frame frozen (nothing written), one active frame, every frame (the
    reset's form, no mask), a random mask; odd N, and F not a multiple of
    the grid (F x N past the resident warps' first pass).  The rows it
    counts are N a decided frame."""
    need_card()
    for f, n in ((5, 37), (7, 8100)):
        app = app_cases(f, n, q, dtype, seed=f + q).cuda()
        gen = torch.Generator().manual_seed(f)
        masks = {"all frozen": torch.zeros(f, dtype=torch.bool),
                 "one active": torch.arange(f) == f // 2,
                 "every frame": None,
                 "random": torch.rand(f, generator=gen) < 0.5}
        for label, mask in masks.items():
            mask = None if mask is None else mask.cuda()
            got = torch.full((f, n), STALE, dtype=torch.int64, device="cuda")
            want = got.clone()
            cuda_decide.reset_device_launches()
            before = cuda_decide.launches
            decide_rows(app, got, mask)
            decide_rows_plain(app, want, mask)
            assert torch.equal(got, want), (label, f, n)
            assert cuda_decide.launches == before + 1
            decided = f if mask is None else int(mask.sum())
            assert cuda_decide.device_launches() == 1
            assert cuda_decide.device_rows() == n * decided, label


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["spa", "list", "ems pallas"])
def test_device_loop_decode_with_k4_on_card(monkeypatch, path):
    """A device-loop decode through K4 equals the host loop's decode through
    the same check-node kernel with the plain decisions (K4 not launched):
    decisions, iterations, flags; the capture records one K4 launch a
    step, and over a replay K4 decides N x (sum of iterations + F) rows:
    each step's active frames and the reset's every frame."""
    need_card()
    q, fields, kernel = PATHS[path]
    code = small_code(q)
    graph = DeviceGraph.from_code(code)
    intr = intrinsics(code, 1.0, 24, "cuda")
    cfg = DecoderConfig(max_iters=8, loop="device", **fields)
    device_loop.clear()
    decode(graph, intr, cfg)                      # the capture
    loop = device_loop.last()
    assert loop.per_step["decide_rows"] == 1
    assert loop.per_step[kernel] > 0
    cuda_decide.reset_device_launches()
    got = decode(graph, intr, cfg)
    rows, launched = cuda_decide.device_rows(), cuda_decide.device_launches()
    monkeypatch.setattr(layered, "decide_rows", decide_rows_plain)
    want = decode(graph, intr, dataclasses.replace(cfg, loop="host"))
    assert cuda_decide.device_launches() == launched
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    steps = int(want[1].max())
    assert 0 < steps and int(want[2].sum()) > 0
    assert launched == steps + 1
    assert rows == code.n * (int(want[1].sum()) + intr.shape[0])
    device_loop.clear()
