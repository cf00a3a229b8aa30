"""The fused layered bubble super-layer step ``cuda_bubble.bubble_layer``:
against the sweep it replaces, its place in the sweep, its guards and its
shared-memory layout.

On a CPU tensor ``bubble_layer`` runs its plain version
``bubble_layer_plain``.  Inputs are made from seeded numpy generators.
Tolerance: none.  The plain step and the sweep as it ran before the fused
kernel (gathers, VN extrinsic minus its min, ``bubble_rows_plain``, two
``torch.where`` for the freeze, scatters) run the same ops in the same
order, so the real columns and edges, the frozen frames and the rows the
layer does not own must be equal bit for bit.  The padding column and edge
are not compared against the old sweep, whose padded slots scattered their
CN outputs there (several slots, one element: which value landed was
unspecified); the fused step writes nothing there, so they stay 0.  The
decodes against the JAX package run through this step in
``tests/test_torch_bubble.py::test_irregular_decode_matches_jax`` and
``tests/test_torch_layered.py::test_bubble_branches_decode_like_jax``.
"""
import numpy as np
import pytest
import torch

from ems_nbldpc_torch.decoder import flooding, layered
from ems_nbldpc_torch.decoder.graph import DeviceGraph
from ems_nbldpc_torch.models.code import from_parsed, random_regular
from ems_nbldpc_torch.models.formats import ParsedMatrix
from ems_nbldpc_torch.ops import bubble_cn, cuda_bubble

OFFSET = 0.3


def irregular_rows(n, m, dc, seed):
    """m rows over n columns with degrees 2..dc (the first of degree dc)."""
    rng = np.random.default_rng(seed)
    degs = [dc] + list(rng.integers(2, dc + 1, m - 1))
    return [np.sort(rng.choice(n, d, replace=False)) for d in degs]


def make_code(kind, q, dc, seed=0):
    """A regular code (dv = 2) of row degree dc, or an irregular one of row
    degrees 2..dc, whose layers carry padded slots (the bubble CN needs
    dc >= 3 of the widest row only: a padded slot is the delta message)."""
    if kind == "regular":
        return random_regular(4 * dc, 8, q, dv=2, seed=seed)
    rows = irregular_rows(16, 8, dc, seed)
    rng = np.random.default_rng(seed + 1)
    coefs = [rng.integers(1, q, len(r)) for r in rows]
    return from_parsed(ParsedMatrix(16, len(rows), q, rows, coefs))


def layer_state(g, plan, f, kind, seed):
    """A decoder-like state (APP [F, N+1, q], CtoV [F, E+1, q]; CtoV 0..10,
    APP = X + CtoV on the layer's slots with X one low-cost symbol per
    column and the rest 2..40; "ties": integer levels 0..5 instead, so
    that equal values are common in the lists and at their edge; padding
    column and edge 0) and active [F] with frames 1 and F-1 frozen."""
    rng = np.random.default_rng(seed)
    q, n, e = g.q, g.code.n, g.n_edges
    if kind == "ties":
        app = rng.integers(0, 6, (f, n + 1, q)).astype(np.float32)
        ctov = rng.integers(0, 6, (f, e + 1, q)).astype(np.float32)
    else:
        app = (2 + 38 * rng.random((f, n + 1, q))).astype(np.float32)
        best = rng.integers(0, q, (f, n + 1))
        np.put_along_axis(app, best[..., None], rng.random((f, n + 1, 1)),
                          -1)
        ctov = (10 * rng.random((f, e + 1, q))).astype(np.float32)
    app[:, n] = 0
    ctov[:, e] = 0
    app, ctov = torch.from_numpy(app), torch.from_numpy(ctov)
    real = plan["edge_ids"] < e
    app[:, plan["cols"][real]] += ctov[:, plan["edge_ids"][real]]
    active = torch.ones(f, dtype=torch.bool)
    active[1] = active[-1] = False
    return app, ctov, active


def pre_fusion_layer(app, ctov, active, p, cn):
    """The layered bubble super-layer as the sweep ran it before the fused
    kernel (``one_iteration`` around the CN step on rows, with the plain
    check node)."""
    act = active[:, None, None, None]
    app_rows = app[:, p["cols"]]
    ctov_rows = ctov[:, p["edge_ids"]]
    mvc = app_rows - ctov_rows
    mvc = mvc - mvc.min(dim=-1, keepdim=True).values
    f, g, dc, q = mvc.shape
    mcv = bubble_cn.bubble_rows_plain(
        mvc.reshape(f * g, dc, q), p["rot_in8"], p["rot_out8"], p["valid"],
        *cn).reshape(mvc.shape)
    mcv = torch.where(act, mcv, ctov_rows)
    new_app = torch.where(act, mvc + mcv, app_rows)
    ctov[:, p["edge_ids"]] = mcv
    app[:, p["cols"]] = new_app


def layer_args(p):
    return (p["cols32"], p["edge_ids32"], p["rot_in8"], p["rot_out8"],
            p["valid"])


def check_layer(g, p, state, cn):
    """``bubble_layer`` on a copy of ``state`` against the pre-fusion
    sweep: the real columns and edges of active frames bit for bit, frozen
    frames and rows the layer does not own untouched, the padding column
    and edge 0; returns whether the step changed what it owns."""
    app, ctov, active = state
    got = app.clone(), ctov.clone()
    cuda_bubble.bubble_layer(*got, active, *layer_args(p), *cn)
    want = app.clone(), ctov.clone()
    pre_fusion_layer(*want, active, p, cn)
    real = (p["edge_ids"] < g.n_edges).numpy()
    own = {"app": p["cols"].numpy()[real], "ctov": p["edge_ids"].numpy()[real]}
    act = active.numpy()
    changed = True
    for name, x0, a, b in zip(("app", "ctov"), (app, ctov), got, want):
        x0, a, b = x0.numpy(), a.numpy(), b.numpy()
        rest = np.setdiff1d(np.arange(x0.shape[1] - 1), own[name])
        # frozen frames and rows the layer does not own: untouched, bit for
        # bit, on both sides (the fused step: the padding row too)
        for y in (a, b):
            np.testing.assert_array_equal(y[~act][:, :-1], x0[~act][:, :-1])
            np.testing.assert_array_equal(y[:, rest], x0[:, rest])
        np.testing.assert_array_equal(a[~act], x0[~act])
        np.testing.assert_array_equal(a[act][:, own[name]].view(np.int32),
                                      b[act][:, own[name]].view(np.int32),
                                      err_msg=name)
        changed = changed and not np.array_equal(a[act][:, own[name]],
                                                 x0[act][:, own[name]])
    # the padding column and edge stay 0
    assert (got[0][:, -1] == 0).all() and (got[1][:, -1] == 0).all()
    return changed


@pytest.mark.parametrize("variant", ["8", "L"])
@pytest.mark.parametrize("kind", ["regular", "irregular"])
@pytest.mark.parametrize("dc", [3, 4, 6])
@pytest.mark.parametrize("q", [16, 64, 256])
def test_bubble_layer_matches_pre_fusion_sweep(q, dc, kind, variant):
    g = DeviceGraph.from_code(make_code(kind, q, dc))
    plans = layered._layer_plan(g, "cpu")
    if kind == "irregular":
        assert any(p["valid"] is not None and not bool(p["valid"].all())
                   for p in plans)
    cn = (8, 20, OFFSET, True, True, variant)
    before = cuda_bubble.launches, cuda_bubble.layer_launches
    for k, p in enumerate(plans):
        state = layer_state(g, p, 5, ("ties", "uniform")[k % 2],
                            seed=10 * q + dc + k)
        assert check_layer(g, p, state, cn)
    # CPU tensors run the plain version: no launch counted
    assert (cuda_bubble.launches, cuda_bubble.layer_launches) == before


# (q, nm, nbOper, offset, truncate) beside the main test's
SETTINGS = {
    "nm_1": (16, 1, 4, OFFSET, True),
    "nm_q": (16, 16, 40, OFFSET, False),
    "nb_oper_below_nm": (64, 16, 8, OFFSET, True),     # unfilled tails
    "negative_offset": (64, 12, 24, -0.2, True),       # saturation bites
    "nb_oper_0": (16, 8, 0, OFFSET, True),             # no bubble step
}


@pytest.mark.parametrize("variant", ["8", "L"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_bubble_layer_settings_match_pre_fusion_sweep(setting, variant):
    """nm = 1, nm = q (no truncation), nbOper < nm, a negative offset
    (where the layered saturation changes the output) and nbOper = 0, on
    an irregular code, both variants."""
    q, nm, nb_oper, offset, truncate = SETTINGS[setting]
    g = DeviceGraph.from_code(make_code("irregular", q, 5, seed=3))
    cn = (nm, nb_oper, offset, truncate, truncate, variant)
    for k, p in enumerate(layered._layer_plan(g, "cpu")):
        for kind in ("ties", "uniform"):
            check_layer(g, p, layer_state(g, p, 6, kind, seed=k), cn)


def test_saturation_bites_at_a_negative_offset():
    """The negative-offset case above is one where the layered saturation
    changes the step's output, so it holds that part of the kernel."""
    q, nm, nb_oper, offset, _ = SETTINGS["negative_offset"]
    g = DeviceGraph.from_code(make_code("irregular", q, 5, seed=3))
    p = layered._layer_plan(g, "cpu")[0]
    app, ctov, active = layer_state(g, p, 6, "uniform", seed=0)
    outs = []
    for saturate in (True, False):
        a, c = app.clone(), ctov.clone()
        cuda_bubble.bubble_layer(a, c, active, *layer_args(p), nm, nb_oper,
                                 offset, True, saturate, "8")
        outs.append(c)
    assert not torch.equal(*outs)


@pytest.mark.parametrize("cn_impl", ["bubble", "lbubble"])
def test_padding_column_and_edge_stay_zero_through_the_sweep(cn_impl):
    """Three steps of the layered bubble stepper on a code with padded
    slots: the padding column N and edge E are never written."""
    g = DeviceGraph.from_code(make_code("irregular", 16, 6))
    init, step = layered.make_layered_stepper(g, 8, OFFSET, "ems", cn_impl,
                                              nboper=16)
    rng = np.random.default_rng(2)
    intr = torch.from_numpy((rng.random((6, g.code.n, 16)) * 6)
                            .astype(np.float32))
    state = init(intr)
    for _ in range(3):
        state = step(state)
    app, ctov = state[:2]
    assert (app[:, g.code.n] == 0).all() and (ctov[:, g.n_edges] == 0).all()
    assert not (ctov[:, :g.n_edges] == 0).all()


@pytest.mark.parametrize("cn_impl,variant", [("bubble", "8"),
                                             ("lbubble", "L")])
def test_bubble_sweep_calls_bubble_layer_once_per_super_layer(
        monkeypatch, cn_impl, variant):
    g = DeviceGraph.from_code(make_code("irregular", 16, 6))
    calls = []

    def counting(*args):
        calls.append((args[3].shape, args[8:]))
        return cuda_bubble.bubble_layer(*args)

    def refuse(*args, **kwargs):
        raise AssertionError("the sweep ran another CN step")

    monkeypatch.setattr(layered, "bubble_layer", counting)
    for name in ("bubble_layer_plain", "ems_rows"):
        monkeypatch.setattr(layered, name, refuse)
    monkeypatch.setattr(flooding, "bubble_rows", refuse)
    monkeypatch.setattr(flooding, "bubble_rows_plain", refuse)
    init, step = layered.make_layered_stepper(g, 8, OFFSET, "ems", cn_impl,
                                              nboper=0)
    rng = np.random.default_rng(5)
    intr = torch.from_numpy((rng.random((4, g.code.n, 16)) * 5)
                            .astype(np.float32))
    step(step(init(intr)))
    assert len(calls) == 2 * len(g.layers)
    assert [c[0] for c in calls[:len(g.layers)]] == [
        (len(rows), g.code.dc_max) for rows in g.layers]
    # nm, nbOper (0: JAX's 2 nm), offset, truncation and saturation (EMS,
    # nm < q), variant
    assert {c[1] for c in calls} == {(8, 16, OFFSET, True, True, variant)}


def test_plain_sweep_runs_the_plain_layer(monkeypatch):
    """``plain=True`` (the card's comparison path) runs
    ``bubble_layer_plain`` once per super-layer, and the same state."""
    g = DeviceGraph.from_code(make_code("regular", 16, 4))
    calls = []

    def counting(*args):
        calls.append(len(args))
        return cuda_bubble.bubble_layer_plain(*args)

    monkeypatch.setattr(layered, "bubble_layer_plain", counting)
    rng = np.random.default_rng(6)
    intr = torch.from_numpy((rng.random((3, g.code.n, 16)) * 5)
                            .astype(np.float32))
    states = []
    for plain in (False, True):
        init, step = layered.make_layered_stepper(g, 8, OFFSET, "ems",
                                                  "bubble", plain=plain,
                                                  nboper=20)
        states.append(step(init(intr.clone())))
    assert len(calls) == len(g.layers)
    assert all(torch.equal(a, b) for a, b in zip(*states))


# ---------------- the kernel's layout ----------------

def test_default_shape_holds_eight_rows_a_warp():
    """dc = 4, q = 256, nm = 32: 8 rows a warp in 13,440 bytes (two staged
    messages 2 KB, the lists 10 KB, their counts, the seen sets 1 KB), so
    16 warps (four blocks of four) share an SM's 228 KB."""
    assert cuda_bubble.rows_per_warp(4, 256, 32) == 8
    assert cuda_bubble.warp_bytes(4, 256, 32, 8) == 13440
    assert 16 * (13440 + 1024 // 4) <= cuda_bubble.SM_SMEM
    assert 16 * (cuda_bubble.warp_bytes(4, 256, 32, 9) + 256) \
        > cuda_bubble.SM_SMEM


def tile_limit_before(dc, q, nm):
    """Whether the design before this one (a block's 64-row tile of lists,
    int16 ids) held one row of (dc, q, nm)."""
    def a16(b):
        return (b + 15) // 16 * 16
    e = (3 * dc - 4) * nm
    words = q // 32 if q >= 32 else 1
    return (a16(4 * e) + a16(2 * e) + 4 * a16(8 * q + 16 * nm)
            + 512 * words) <= 232448


@pytest.mark.parametrize("q", [4, 16, 64, 256])
def test_limits_only_widen(q):
    """Every (dc, nm) the design before this one took still runs."""
    for dc in range(3, 60):
        for nm in range(1, q + 1):
            if tile_limit_before(dc, q, nm):
                assert cuda_bubble.rows_per_warp(dc, q, nm) >= 1, (dc, nm)


def test_widest_rows_take_one_warp_a_block():
    """Rows the tile refused now fit one warp's lists in a block; past
    that the wrapper raises on any device."""
    assert not tile_limit_before(50, 256, 256)
    assert cuda_bubble.rows_per_warp(50, 256, 256) == 1
    assert cuda_bubble.rows_per_warp(80, 256, 256) == 0
    with pytest.raises(ValueError, match="shared memory"):
        cuda_bubble.bubble_rows(torch.zeros((1, 80, 256)),
                                torch.zeros((1, 80, 256), dtype=torch.uint8),
                                torch.zeros((1, 80, 256), dtype=torch.uint8),
                                None, 256, 4, OFFSET, False, False)


# ---------------- bad inputs ----------------

def rejection_case(bad):
    """(arguments of bubble_layer, expected exception) for one bad input."""
    f, n1, e1, g, dc, q = 3, 9, 13, 2, 4, 16
    app = torch.zeros((f, n1, q))
    ctov = torch.zeros((f, e1, q))
    active = torch.ones(f, dtype=torch.bool)
    idx = torch.arange(g * dc, dtype=torch.int32).reshape(g, dc)
    cols, edges = idx.clone(), idx.clone()
    rot = torch.arange(q, dtype=torch.uint8).repeat(g, dc, 1)
    rin, rout, valid = rot.clone(), rot.clone(), None
    nm, nb_oper, variant = 8, 16, "8"
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
        cols = cols.to("meta")
    elif bad == "cols_int64":
        cols = cols.long()
    elif bad == "edges_width":
        edges = edges[:, :3].contiguous()
    elif bad == "active_uint8":
        active = active.to(torch.uint8)
    elif bad == "active_shape":
        active = torch.ones(f + 1, dtype=torch.bool)
    elif bad == "rot_rows":
        rin = rot[:1].contiguous()
    elif bad == "rot_int64":
        rout = rot.long()
    elif bad == "valid_uint8":
        valid = torch.ones((g, dc), dtype=torch.uint8)
    elif bad == "q_not_pow2":
        app, ctov = app[..., :12].contiguous(), ctov[..., :12].contiguous()
        rin = rout = rot[..., :12].contiguous()
    elif bad == "dc_2":
        cols, edges = cols[:, :2].contiguous(), edges[:, :2].contiguous()
        rin = rout = rot[:, :2].contiguous()
    elif bad == "nm_0":
        nm = 0
    elif bad == "nm_above_q":
        nm = q + 1
    elif bad == "nb_oper_negative":
        nb_oper = -1
    elif bad == "variant":
        variant = "4"
    elif bad == "col_out_of_range":      # torch's own indexing checks it
        cols, err = cols + n1, IndexError
    return ((app, ctov, active, cols, edges, rin, rout, valid, nm, nb_oper,
             OFFSET, True, True, variant), err)


@pytest.mark.parametrize("bad", [
    "float64", "ctov_float16", "2d", "noncontig", "device", "cols_int64",
    "edges_width", "active_uint8", "active_shape", "rot_rows", "rot_int64",
    "valid_uint8", "q_not_pow2", "dc_2", "nm_0", "nm_above_q",
    "nb_oper_negative", "variant", "col_out_of_range"])
def test_bubble_layer_rejects_bad_inputs(bad):
    args, err = rejection_case(bad)
    with pytest.raises(err):
        cuda_bubble.bubble_layer(*args)


def test_rejection_case_is_valid_when_nothing_is_bad():
    """The cases above differ from a call that runs by one input each."""
    args, _ = rejection_case("none")
    cuda_bubble.bubble_layer(*args)


@pytest.mark.cuda
def test_bubble_layer_matches_plain_on_card():
    """The fused entry against its plain version at small shapes, bit for
    bit, both variants (card only; chip_smoke.py runs the full-size
    comparison)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for q, dc, kind in [(256, 4, "regular"), (16, 6, "irregular"),
                        (64, 3, "irregular")]:
        g = DeviceGraph.from_code(make_code(kind, q, dc))
        for k, p in enumerate(layered._layer_plan(g, "cuda")):
            pc = layered._layer_plan(g, "cpu")[k]
            state = layer_state(g, pc, 6, "ties", seed=k)
            app, ctov, active = (x.cuda() for x in state)
            for variant in ("8", "L"):
                cn = (min(8, q), 20, OFFSET, True, True, variant)
                got = app.clone(), ctov.clone()
                before = cuda_bubble.layer_launches
                cuda_bubble.bubble_layer(*got, active, *layer_args(p), *cn)
                assert cuda_bubble.layer_launches == before + 1
                want = app.clone(), ctov.clone()
                cuda_bubble.bubble_layer_plain(*want, active, *layer_args(p),
                                               *cn)
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])
