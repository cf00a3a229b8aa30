"""The fused EMS check-node step ``cuda_cn.ems_rows`` against the JAX
package and against the decoders' unfused routes.

``ems_rows`` (on a CPU tensor: its plain version ``ems_rows_plain``) must
equal, bit for bit, the composition built from the JAX package's own ops:
``ems_input_truncate``, the rotation (a gather through the JAX GF tables),
``fb_checknode_topk`` with ``valid``, the rotation back,
``ems_output_saturate`` and min-normalisation.  Each step is a selection, a
gather, an exact min or one f32 add, so there is no tolerance.  Inputs are
min-normalised rows from a seeded numpy generator; "ties" inputs draw from
a few integer levels so that the lower-GF-id-first tie order of the lists
and the ties at the truncation threshold matter."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ems_nbldpc_tpu.gf import get_gf as jget_gf
from ems_nbldpc_tpu.models.code import from_parsed as jfrom_parsed
from ems_nbldpc_tpu.models.formats import ParsedMatrix as JParsedMatrix
from ems_nbldpc_tpu.ops import minconv as jmc

from ems_nbldpc_torch.decoder import flooding, layered
from ems_nbldpc_torch.decoder.graph import DeviceGraph, rotation_table
from ems_nbldpc_torch.models.code import from_jax_code, random_regular
from ems_nbldpc_torch.ops import cuda_cn
from ems_nbldpc_torch.ops.minconv import ems_output_saturate

OFFSET = 0.3


def rows(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        v = rng.integers(0, 6, shape).astype(np.float32)
    else:
        v = (rng.random(shape) * 9).astype(np.float32)
    return v - v.min(axis=-1, keepdims=True)


def coef_tables(g, dc, q, padding, seed):
    """[G, dc] coefficients (0 at a few slots with ``padding``), and the
    JAX GF's gather tables for them, [G, dc, q] each."""
    rng = np.random.default_rng(seed)
    coefs = rng.integers(1, q, (g, dc))
    if padding:
        coefs[0, -1] = 0
        coefs[rng.integers(0, g, 3), rng.integers(0, dc, 3)] = 0
    gf = jget_gf(q)
    h = np.where(coefs == 0, 1, coefs)
    return coefs, gf.mul_table[gf.inv(h)], gf.mul_table[h]


def jax_composition(x, t_in, t_out, valid, nm, truncate):
    """x: [F, G, dc, q]; t_in / t_out: [G, dc, q]; valid: [G, dc] or None."""
    v = np.asarray(jmc.ems_input_truncate(jnp.asarray(x), nm)) if truncate \
        else x
    vr = np.take_along_axis(v, np.broadcast_to(t_in, v.shape), -1)
    out = np.asarray(jmc.fb_checknode_topk(
        jnp.asarray(vr), nm, None if valid is None else jnp.asarray(valid)))
    out = np.take_along_axis(out, np.broadcast_to(t_out, out.shape), -1)
    if truncate:
        out = np.asarray(jmc.ems_output_saturate(jnp.asarray(out), nm,
                                                 OFFSET))
    return out - out.min(axis=-1, keepdims=True)


CASES = [  # q, dc, nm, truncate, kind, padding
    (16, 3, 5, True, "ties", True), (16, 4, 6, True, "uniform", True),
    (16, 6, 4, True, "ties", True), (16, 4, 16, True, "ties", True),
    (16, 3, 16, False, "uniform", True), (16, 6, 7, False, "ties", False),
    (256, 3, 32, True, "uniform", True), (256, 4, 32, True, "ties", True),
    (256, 6, 24, True, "uniform", False), (256, 4, 256, False, "ties", True),
    (256, 4, 32, False, "uniform", True), (256, 6, 256, True, "ties", True),
]


@pytest.mark.parametrize("q,dc,nm,truncate,kind,padding", CASES)
def test_ems_rows_matches_jax_composition(q, dc, nm, truncate, kind,
                                          padding):
    f, g = 3, 5
    x = rows((f, g, dc, q), kind, seed=q + dc + nm)
    coefs, t_in, t_out = coef_tables(g, dc, q, padding, seed=dc)
    valid = coefs != 0 if padding else None
    want = jax_composition(x, t_in, t_out, valid, nm, truncate)
    # the port's tables are the same gathers, as uint8
    rin, rout = (rotation_table(coefs, jget_gf(q), d).reshape(g, dc, q)
                 for d in ("in", "out"))
    np.testing.assert_array_equal(rin, t_in)
    np.testing.assert_array_equal(rout, t_out)
    got = cuda_cn.ems_rows(
        torch.from_numpy(x.reshape(f * g, dc, q)),
        torch.from_numpy(rin.astype(np.uint8)),
        torch.from_numpy(rout.astype(np.uint8)),
        None if valid is None else torch.from_numpy(valid), nm, OFFSET,
        truncate)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    assert (got.min(dim=-1).values == 0).all()


def tiny_irregular():
    """The hand-built GF(16) code of ``tests/test_decoder_e2e.py``: rows of
    degree 3 and 2, so padded row slots."""
    rows_ = [np.array([0, 1, 2]), np.array([1, 3]), np.array([0, 3, 4]),
             np.array([2, 4])]
    coefs = [np.array([1, 3, 7]), np.array([2, 5]), np.array([4, 9, 1]),
             np.array([6, 8])]
    return from_jax_code(jfrom_parsed(JParsedMatrix(5, 4, 16, rows_, coefs),
                                      name="tiny_irr"))


@pytest.mark.parametrize("code", ["regular", "irregular"])
@pytest.mark.parametrize("cn,nm", [("ems", 6), ("minsum", 6), ("ems", 16)])
def test_plain_matches_layered_topk_route(code, cn, nm):
    """``ems_rows_plain`` on a layer plan equals the layered sweep's
    unfused ``topk`` route: truncate, rotate, mask, CN, rotate back,
    saturate, normalise."""
    c = random_regular(96, 48, 16, seed=0) if code == "regular" \
        else tiny_irregular()
    g = DeviceGraph.from_code(c)
    rotated_cn = layered._make_rotated_cn(g, nm, cn, "topk")
    truncate = cn == "ems" and nm < c.q
    for i, p in enumerate(layered._layer_plan(g, "cpu")):
        gdim, dc = p["shape"]
        mvc = torch.from_numpy(rows((4, gdim, dc, c.q), "ties", seed=i))
        want = rotated_cn(mvc, p)
        if truncate:
            want = ems_output_saturate(want, nm, OFFSET)
        want = want - want.min(dim=-1, keepdim=True).values
        got = cuda_cn.ems_rows_plain(mvc.reshape(-1, dc, c.q), p["rot_in8"],
                                     p["rot_out8"], p["valid"], nm, OFFSET,
                                     truncate)
        assert torch.equal(got.reshape(want.shape), want)
    assert code == "regular" or any(p["valid"] is not None
                                    for p in layered._layer_plan(g, "cpu"))


@pytest.mark.parametrize("code", ["regular", "irregular"])
@pytest.mark.parametrize("cn,nm,kind", [("ems", 5, "ties"),
                                        ("ems", 5, "uniform"),
                                        ("minsum", 4, "ties")])
def test_plain_matches_flooding_topk_route(code, cn, nm, kind):
    """The flooding step's fused route (unrotated row gather, per-row
    tables from the row coefficients) equals its unfused ``topk`` route
    (per-edge rotations, delta padding edge), which ``plain`` runs (every
    other ``cn_impl`` takes the fused route where K1 takes the rows)."""
    c = random_regular(48, 24, 16, seed=3) if code == "regular" \
        else tiny_irregular()
    g = DeviceGraph.from_code(c)
    assert g.regular == (code == "regular")
    vtoc = torch.from_numpy(rows((6, c.n_edges, c.q), kind, seed=nm))
    want = flooding.checknode(g, vtoc, nm, OFFSET, cn, "topk", plain=True)
    for impl in ("pallas", "topk"):
        got = flooding.checknode(g, vtoc, nm, OFFSET, cn, impl)
        assert torch.equal(got, want), impl


BAD = ["x_float64", "x_2d", "rot_in_int64", "rot_out_shape", "valid_uint8",
       "valid_shape", "tables_disagree", "t_not_multiple", "nm0", "dc0",
       "no_rot_in", "no_rot_out"]


@pytest.mark.parametrize("bad", BAD)
def test_ems_rows_rejects_bad_inputs(bad):
    g, dc, q, nm = 3, 4, 16, 4
    x = torch.from_numpy(rows((2 * g, dc, q), "uniform", seed=0))
    rin = torch.zeros((g, dc, q), dtype=torch.uint8)
    rout = torch.zeros((g, dc, q), dtype=torch.uint8)
    valid = torch.ones((g, dc), dtype=torch.bool)
    err = ValueError
    if bad == "x_float64":
        x, err = x.double(), TypeError
    elif bad == "x_2d":
        x = x.reshape(-1, q)
    elif bad == "rot_in_int64":
        rin = rin.long()
    elif bad == "rot_out_shape":
        rout = rout[:, :, :8].contiguous()
    elif bad == "valid_uint8":
        valid = valid.to(torch.uint8)
    elif bad == "valid_shape":
        valid = valid[:, :3].contiguous()
    elif bad == "tables_disagree":
        rout = torch.zeros((g + 1, dc, q), dtype=torch.uint8)
    elif bad == "t_not_multiple":
        x = x[:-1].contiguous()
    elif bad == "nm0":
        nm = 0
    elif bad == "no_rot_in":
        rin = None
    elif bad == "no_rot_out":
        rout = None
    elif bad == "dc0":
        x, rin, rout, valid = (x[:, :0].contiguous(),
                               rin[:, :0].contiguous(),
                               rout[:, :0].contiguous(),
                               valid[:, :0].contiguous())
    with pytest.raises(err):
        cuda_cn.ems_rows(x, rin, rout, valid, nm, OFFSET, True)
    if "rot" in bad or "valid" in bad or bad in ("tables_disagree",
                                                  "t_not_multiple"):
        with pytest.raises(err):        # the plain version checks tables
            cuda_cn.ems_rows_plain(x, rin, rout, valid, nm, OFFSET, True)


def test_cpu_calls_count_no_launch():
    x = torch.from_numpy(rows((6, 4, 16), "uniform", seed=2))
    tab = torch.arange(16, dtype=torch.uint8).repeat(3, 4, 1)
    before = cuda_cn.launches
    cuda_cn.ems_rows(x, tab, tab, None, 4, OFFSET, True)
    cuda_cn.fb_checknode(x, 4)
    assert cuda_cn.launches == before


@pytest.mark.cuda
def test_ems_rows_kernel_matches_plain_on_card():
    """The kernel against its plain version at small shapes, with tables,
    padding and both modes (card only; chip_smoke.py runs the main paths'
    shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for q, dc, nm, truncate, kind, padding in CASES:
        f, g = 7, 11
        x = torch.from_numpy(rows((f * g, dc, q), kind, seed=q + nm)).cuda()
        coefs, t_in, t_out = coef_tables(g, dc, q, padding, seed=dc)
        rin, rout = (torch.from_numpy(t.astype(np.uint8)).cuda()
                     for t in (t_in, t_out))
        valid = torch.from_numpy(coefs != 0).cuda() if padding else None
        before = cuda_cn.launches
        got = cuda_cn.ems_rows(x, rin, rout, valid, nm, OFFSET, truncate)
        assert cuda_cn.launches == before + 1
        want = cuda_cn.ems_rows_plain(x, rin, rout, valid, nm, OFFSET,
                                      truncate)
        assert torch.equal(got, want), (q, dc, nm, truncate, kind, padding)
