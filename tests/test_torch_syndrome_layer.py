"""The fused layered syndrome super-layer step
``cuda_syndrome.syndrome_layer``: against the torch composition it
replaces, its host-built position lists, and its place in the sweep.

On a CPU tensor ``syndrome_layer`` runs its plain version
``syndrome_layer_plain``.  Inputs are made from seeded numpy generators.
Tolerance: none.  The plain step and the sweep as it ran before the fused
kernel (gathers, VN extrinsic minus its min, ``syndrome_rows_plain``, two
``torch.where`` for the freeze, scatters) run the same ops in the same
order, so the real columns and edges, the frozen frames and the rows the
layer does not own must be equal bit for bit.  The padding column and edge
are not compared against the old sweep, whose padded slots scattered their
CN outputs there (several slots, one element: which value landed was
unspecified); the fused step writes nothing there, so they stay 0.  The
decode against the JAX package runs through this step in
``tests/test_torch_syndrome.py::test_decode_equals_jax`` (both schedules,
both loops).
"""
import numpy as np
import pytest
import torch

from ems_nbldpc_torch.decoder import flooding, layered
from ems_nbldpc_torch.decoder.graph import DeviceGraph
from ems_nbldpc_torch.models.code import from_parsed, random_regular
from ems_nbldpc_torch.models.formats import ParsedMatrix
from ems_nbldpc_torch.ops import cuda_syndrome, syndrome_cn

OFFSET = 0.3
SMALL = dict(d1=7, d2=3, d3=2)          # small tables: C = 89 at dc = 4


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


def layer_state(g, plan, f, kind, seed):
    """A decoder-like state (APP [F, N+1, q], CtoV [F, E+1, q]; CtoV 0..10,
    APP = X + CtoV on the layer's slots with X one low-cost symbol per
    column and the rest 2..40; "ties": integer levels 0..5 instead; padding
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


def cn_args(dc, q, bayes, presort):
    """(table, kth, nm, offset, bayes, presort) and the position lists of
    the decoder's cache for the small table."""
    syn = dict(SMALL, use_bayes=bayes, presort=presort)
    return flooding.syndrome_args(dc, q, 0, OFFSET, syn, "cpu")


def pre_fusion_layer(app, ctov, active, p, cn):
    """The layered syndrome super-layer as the sweep ran it before the
    fused kernel (with the plain check node)."""
    act = active[:, None, None, None]
    app_rows = app[:, p["cols"]]
    ctov_rows = ctov[:, p["edge_ids"]]
    mvc = app_rows - ctov_rows
    mvc = mvc - mvc.min(dim=-1, keepdim=True).values
    f, g, dc, q = mvc.shape
    mcv = cuda_syndrome.syndrome_rows_plain(
        mvc.reshape(f * g, dc, q), p["rot_in8"], p["rot_out8"], p["valid"],
        *cn).reshape(mvc.shape)
    mcv = torch.where(act, mcv, ctov_rows)
    new_app = torch.where(act, mvc + mcv, app_rows)
    ctov[:, p["edge_ids"]] = mcv
    app[:, p["cols"]] = new_app


def layer_args(p):
    return (p["cols32"], p["edge_ids32"], p["rot_in8"], p["rot_out8"],
            p["valid"])


@pytest.mark.parametrize("switches", [(True, True), (False, False)])
@pytest.mark.parametrize("kind", ["regular", "irregular"])
@pytest.mark.parametrize("dc", [3, 4, 6])
@pytest.mark.parametrize("q", [16, 64, 256])
def test_syndrome_layer_matches_pre_fusion_sweep(q, dc, kind, switches):
    g = DeviceGraph.from_code(make_code(kind, q, dc))
    plans = layered._layer_plan(g, "cpu")
    if kind == "irregular":
        assert any(p["valid"] is not None and not bool(p["valid"].all())
                   for p in plans)
    cn, lists = cn_args(dc, q, *switches)
    before = cuda_syndrome.launches, cuda_syndrome.layer_launches
    for k, p in enumerate(plans):
        app, ctov, active = layer_state(g, p, 5, ("ties", "uniform")[k % 2],
                                        seed=10 * q + dc + k)
        got = app.clone(), ctov.clone()
        cuda_syndrome.syndrome_layer(*got, active, *layer_args(p), *cn,
                                     lists)
        want = app.clone(), ctov.clone()
        pre_fusion_layer(*want, active, p, cn)
        real = (p["edge_ids"] < g.n_edges).numpy()
        own = {"app": p["cols"].numpy()[real],
               "ctov": p["edge_ids"].numpy()[real]}
        act = active.numpy()
        for name, x0, a, b in zip(("app", "ctov"), (app, ctov), got, want):
            x0, a, b = x0.numpy(), a.numpy(), b.numpy()
            rest = np.setdiff1d(np.arange(x0.shape[1] - 1), own[name])
            # frozen frames and rows the layer does not own: untouched, bit
            # for bit, on both sides (the fused step: the padding row too)
            for y in (a, b):
                np.testing.assert_array_equal(y[~act][:, :-1],
                                              x0[~act][:, :-1])
                np.testing.assert_array_equal(y[:, rest], x0[:, rest])
            np.testing.assert_array_equal(a[~act], x0[~act])
            np.testing.assert_array_equal(a[act][:, own[name]],
                                          b[act][:, own[name]],
                                          err_msg=f"{name} layer {k}")
            # the step changed what it owns
            assert not np.array_equal(a[act][:, own[name]],
                                      x0[act][:, own[name]])
        # the padding column and edge stay 0
        assert (got[0][:, -1] == 0).all() and (got[1][:, -1] == 0).all()
    # CPU tensors run the plain version: no launch counted
    assert (cuda_syndrome.launches, cuda_syndrome.layer_launches) == before


def test_padding_column_and_edge_stay_zero_through_the_sweep():
    """Three steps of the layered syndrome stepper on a code with padded
    slots: the padding column N and edge E are never written."""
    g = DeviceGraph.from_code(make_code("irregular", 16, 6))
    init, step = layered.make_layered_stepper(g, 8, OFFSET, "syndrome",
                                              syn=SMALL)
    rng = np.random.default_rng(2)
    intr = torch.from_numpy((rng.random((6, g.code.n, 16)) * 6)
                            .astype(np.float32))
    state = init(intr)
    for _ in range(3):
        state = step(state)
    app, ctov = state[:2]
    assert (app[:, g.code.n] == 0).all() and (ctov[:, g.n_edges] == 0).all()
    assert not (ctov[:, :g.n_edges] == 0).all()


def test_syndrome_sweep_calls_syndrome_layer_once_per_super_layer(
        monkeypatch):
    g = DeviceGraph.from_code(make_code("irregular", 16, 6))
    calls = []

    def counting(*args):
        calls.append(args[3].shape)
        return cuda_syndrome.syndrome_layer(*args)

    def refuse(*args):
        raise AssertionError("the sweep ran another CN step")

    monkeypatch.setattr(layered, "syndrome_layer", counting)
    for name in ("syndrome_layer_plain", "ems_rows"):
        monkeypatch.setattr(layered, name, refuse)
    monkeypatch.setattr(flooding, "syndrome_step", refuse)
    init, step = layered.make_layered_stepper(g, 8, OFFSET, "syndrome",
                                              syn=SMALL)
    rng = np.random.default_rng(5)
    intr = torch.from_numpy((rng.random((4, g.code.n, 16)) * 5)
                            .astype(np.float32))
    step(step(init(intr)))
    assert len(calls) == 2 * len(g.layers)
    assert calls[:len(g.layers)] == [(len(rows), g.code.dc_max)
                                     for rows in g.layers]


def test_plain_sweep_runs_the_plain_layer(monkeypatch):
    """``plain=True`` (the card's comparison path) runs
    ``syndrome_layer_plain`` once per super-layer, and the same state."""
    g = DeviceGraph.from_code(make_code("regular", 16, 4))
    calls = []

    def counting(*args):
        calls.append(len(args))
        return cuda_syndrome.syndrome_layer_plain(*args)

    monkeypatch.setattr(layered, "syndrome_layer_plain", counting)
    rng = np.random.default_rng(6)
    intr = torch.from_numpy((rng.random((3, g.code.n, 16)) * 5)
                            .astype(np.float32))
    states = []
    for plain in (False, True):
        init, step = layered.make_layered_stepper(g, 8, OFFSET, "syndrome",
                                                  plain=plain, syn=SMALL)
        states.append(step(init(intr.clone())))
    assert len(calls) == len(g.layers)
    assert all(torch.equal(a, b) for a, b in zip(*states))


# ---------------- host-built position lists ----------------

@pytest.mark.parametrize("shape", ["full", "trapeze", "2dev", "bordered"])
@pytest.mark.parametrize("dc", [3, 4, 6, 12])
def test_position_lists_are_the_deviation_free_configs(dc, shape):
    cfg, kth = syndrome_cn.syndrome_tables(dc, 16, 20, 9, 4, 2, shape)
    lists = cuda_syndrome.position_lists(cfg, kth, 16)
    offsets = lists.offsets.numpy()
    configs = lists.configs.numpy().view(np.uint16)
    assert lists.offsets.dtype == torch.int32
    assert (lists.nm, lists.n_configs) == (16, cfg.shape[0])
    assert offsets[0] == 0 and offsets[-1] == configs.shape[0]
    for t in range(dc):
        want = np.flatnonzero(cfg[:, t] == 0)
        np.testing.assert_array_equal(configs[offsets[t]:offsets[t + 1]],
                                      want)
        assert lists.counts[t] == want.shape[0]
    # the same lists from the device tables' tensors
    again = cuda_syndrome.position_lists(
        torch.from_numpy(cfg.astype(np.uint8)),
        torch.from_numpy(kth.astype(np.int32)), 16)
    assert torch.equal(again.configs, lists.configs)


def test_default_lists_fit_the_registers():
    """The default table (dc = 4, nm = 32): 489 configs a position, within
    the 512 a warp holds in registers, so one row's shared memory is
    12,192 bytes (the staged row, lists, scratch, syndromes, buckets)."""
    tabs = flooding._syndrome_tables(4, 32, flooding.syn_key(None), "cpu")
    assert tabs["lists"].counts == (489,) * 4
    assert max(tabs["lists"].counts) <= cuda_syndrome.REG_CONFIGS
    assert cuda_syndrome.smem_bytes(4, 256, 32, 993, 489) == 12192
    # past the registers, 2 bytes a masked config more
    assert (cuda_syndrome.smem_bytes(4, 256, 32, 993, 600)
            == 12192 + 2 * 88)


def bad_tables(bad):
    """(table, kth, nm) for one table the kernel would misread."""
    cfg, kth = syndrome_cn.syndrome_tables(4, 8, **SMALL)
    cfg, kth, nm = cfg.copy(), kth.copy(), 8
    if bad == "deviation_nm":
        cfg[5, 2] = 8
    elif bad == "deviation_negative":
        cfg[5, 2] = -1
    elif bad == "kth_negative":
        kth[1] = -1
    elif bad == "kth_count":
        kth[3] = int((cfg[:, 3] == 0).sum())
    elif bad == "no_configs":
        cfg = cfg[:0]
    elif bad == "too_many_configs":
        cfg = np.zeros((65537, 4), np.int64)
    elif bad == "kth_width":
        kth = kth[:3]
    return cfg, kth, nm


@pytest.mark.parametrize("bad", ["deviation_nm", "deviation_negative",
                                 "kth_negative", "kth_count", "no_configs",
                                 "too_many_configs", "kth_width"])
def test_position_lists_raise_where_the_kernel_would_misread(bad):
    with pytest.raises(ValueError):
        cuda_syndrome.position_lists(*bad_tables(bad))


def test_rows_raise_on_a_deviation_past_nm():
    """The old kernel trapped on a deviation >= nm; the wrapper raises, on
    any device, before the plain version or the kernel runs."""
    cfg, kth = syndrome_cn.syndrome_tables(4, 8, **SMALL)
    cfg = cfg.copy()
    cfg[7, 0] = 9
    x = torch.zeros((6, 4, 16))
    tab = torch.zeros((3, 4, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="deviations"):
        cuda_syndrome.syndrome_rows(
            x, tab, tab, None, torch.from_numpy(cfg.astype(np.uint8)),
            torch.from_numpy(kth.astype(np.int32)), 8, OFFSET, True, True)


# ---------------- bad inputs ----------------

def rejection_case(bad):
    """(arguments of syndrome_layer, expected exception) for one bad
    input."""
    f, n1, e1, g, dc, q = 3, 9, 13, 2, 4, 16
    app = torch.zeros((f, n1, q))
    ctov = torch.zeros((f, e1, q))
    active = torch.ones(f, dtype=torch.bool)
    idx = torch.arange(g * dc, dtype=torch.int32).reshape(g, dc)
    cols, edges = idx.clone(), idx.clone()
    rot = torch.arange(q, dtype=torch.uint8).repeat(g, dc, 1)
    rin, rout, valid = rot.clone(), rot.clone(), None
    (table, kth, nm, offset, bayes, presort), lists = cn_args(dc, q, True,
                                                              True)
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
    elif bad == "table_dc":
        table = table[:, :3].contiguous()
    elif bad == "kth_int64":
        kth = kth.long()
    elif bad == "lists_nm":
        lists = lists._replace(nm=nm + 1)
    elif bad == "q_not_pow2":
        app, ctov = app[..., :12].contiguous(), ctov[..., :12].contiguous()
        rin = rout = rot[..., :12].contiguous()
    elif bad == "nm2_presort":
        nm = 2
    elif bad == "col_out_of_range":      # torch's own indexing checks it
        cols, err = cols + n1, IndexError
    return ((app, ctov, active, cols, edges, rin, rout, valid, table, kth,
             nm, offset, bayes, presort, lists), err)


@pytest.mark.parametrize("bad", [
    "float64", "ctov_float16", "2d", "noncontig", "device", "cols_int64",
    "edges_width", "active_uint8", "active_shape", "rot_rows", "rot_int64",
    "valid_uint8", "table_dc", "kth_int64", "lists_nm", "q_not_pow2",
    "nm2_presort", "col_out_of_range"])
def test_syndrome_layer_rejects_bad_inputs(bad):
    args, err = rejection_case(bad)
    with pytest.raises(err):
        cuda_syndrome.syndrome_layer(*args)


def test_rejection_case_is_valid_when_nothing_is_bad():
    """The cases above differ from a call that runs by one input each."""
    args, _ = rejection_case("none")
    cuda_syndrome.syndrome_layer(*args)


@pytest.mark.cuda
def test_syndrome_layer_matches_plain_on_card():
    """The fused entry against its plain version at small shapes, bit for
    bit (card only; chip_smoke.py runs the full-size comparison)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for q, dc, kind in [(256, 4, "regular"), (16, 6, "irregular"),
                        (64, 3, "irregular")]:
        g = DeviceGraph.from_code(make_code(kind, q, dc))
        cn, lists = flooding.syndrome_args(dc, q, 0, OFFSET, SMALL, "cuda")
        for k, p in enumerate(layered._layer_plan(g, "cuda")):
            pc = layered._layer_plan(g, "cpu")[k]
            state = layer_state(g, pc, 6, "ties", seed=k)
            app, ctov, active = (x.cuda() for x in state)
            got = app.clone(), ctov.clone()
            before = cuda_syndrome.layer_launches
            cuda_syndrome.syndrome_layer(*got, active, *layer_args(p), *cn,
                                         lists)
            assert cuda_syndrome.layer_launches == before + 1
            want = app.clone(), ctov.clone()
            cuda_syndrome.syndrome_layer_plain(*want, active,
                                               *layer_args(p), *cn)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
