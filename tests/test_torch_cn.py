"""The check node and the ops around it: the port against the JAX package.

Every comparison is exact: the CN is min over single f32 adds, the
truncation/saturation are selections, the rotation is a permutation and
the syndrome is GF integer logic.  Inputs come from a seeded numpy
generator; "ties" inputs draw from a few integer levels so that equal
values (and the lower-GF-id-first tie order of ``lax.top_k``) matter."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ems_nbldpc_tpu.decoder.flooding import syndrome_ok as jsyndrome_ok
from ems_nbldpc_tpu.decoder.graph import DeviceGraph as JGraph
from ems_nbldpc_tpu.models.code import random_regular as jrandom_regular
from ems_nbldpc_tpu.ops import minconv as jmc

from ems_nbldpc_torch.decoder.flooding import syndrome_ok
from ems_nbldpc_torch.decoder.graph import DeviceGraph, rotate, rotation_table
from ems_nbldpc_torch.models.code import from_jax_code
from ems_nbldpc_torch.ops import cuda_cn
from ems_nbldpc_torch.ops import minconv as tmc


def make_rows(t, dc, q, nm, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        v = rng.integers(0, 6, (t, dc, q)).astype(np.float32)
    else:
        v = rng.random((t, dc, q)).astype(np.float32) * 9
    if kind in ("truncated", "ties"):
        v = np.array(jmc.ems_input_truncate(jnp.asarray(v), nm))
    return v


@pytest.mark.parametrize("dc,q,nm,kind", [
    (4, 256, 32, "ties"), (4, 256, 32, "truncated"), (4, 16, 8, "ties"),
    (5, 32, 6, "truncated"), (6, 16, 16, "uniform")])
def test_plain_cn_matches_jax_topk(dc, q, nm, kind):
    # fb_checknode_topk is the Pallas kernel's own exact reference
    # (tests/test_pallas_cn.py holds them equal at (4, 16, 8) and
    # (5, 32, 6)); Pallas interpret mode itself runs in one layered decode
    # (test_torch_layered.py), as it costs seconds per call on the CPU
    v = make_rows(40, dc, q, nm, kind, seed=1)
    want = np.asarray(jmc.fb_checknode_topk(jnp.asarray(v), nm))
    got = cuda_cn.fb_checknode(torch.from_numpy(v), nm)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tmc.fb_checknode_topk(torch.from_numpy(v).reshape(4, 10, dc, q),
                              nm).reshape(-1, dc, q).numpy(), want)


def test_wrapper_counts_only_kernel_launches():
    before = cuda_cn.launches
    cuda_cn.fb_checknode(torch.from_numpy(make_rows(8, 4, 16, 4, "uniform")), 4)
    assert cuda_cn.launches == before   # CPU tensors run the plain version


@pytest.mark.parametrize("q,nm,kind", [(16, 5, "ties"), (256, 32, "uniform"),
                                       (256, 32, "ties"), (64, 64, "ties")])
def test_truncate_saturate_topk_exact(q, nm, kind):
    v = make_rows(30, 3, q, nm, kind, seed=2)
    jv, tv = jnp.asarray(v), torch.from_numpy(v)
    np.testing.assert_array_equal(tmc.ems_input_truncate(tv, nm).numpy(),
                                  np.asarray(jmc.ems_input_truncate(jv, nm)))
    np.testing.assert_array_equal(
        tmc.ems_output_saturate(tv, nm, 0.3).numpy(),
        np.asarray(jmc.ems_output_saturate(jv, nm, 0.3)))
    for a, b in zip(tmc.topk_message(tv, nm), jmc.topk_message(jv, nm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tmc.delta_message((2,), q).numpy(),
        np.asarray(jmc.delta_message((2,), q)))


@pytest.mark.parametrize("q", [16, 256])
def test_rotation_exact(q):
    jc = jrandom_regular(64, 32, q, seed=7)
    jg = JGraph.from_code(jc)
    tc = from_jax_code(jc)
    x = np.random.default_rng(3).random((3, jc.n_edges, q)).astype(np.float32)
    tables = {d: torch.from_numpy(rotation_table(tc.edge_coef, tc.gf, d))
              for d in ("in", "out")}
    for direction in ("in", "out"):
        want = np.asarray(jg.rotplan.apply(jnp.asarray(x), direction,
                                           "grouped"))
        got = rotate(torch.from_numpy(x), tables[direction])
        np.testing.assert_array_equal(got.numpy(), want)
    # "in" then "out" is the identity
    back = rotate(rotate(torch.from_numpy(x), tables["in"]), tables["out"])
    assert torch.equal(back, torch.from_numpy(x))


@pytest.mark.parametrize("q", [16, 256])
def test_syndrome_ok_exact(q):
    jc = jrandom_regular(48, 24, q, seed=8)
    jg = JGraph.from_code(jc)
    tg = DeviceGraph.from_code(from_jax_code(jc))
    d = np.random.default_rng(4).integers(0, q, (64, jc.n))
    d[:8] = 0                               # the zero word satisfies H
    want = np.asarray(jsyndrome_ok(jg, jnp.asarray(d, jnp.int32)))
    got = syndrome_ok(tg, torch.from_numpy(d))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:8].all() and not got[8:].all()


@pytest.mark.parametrize("bad", [
    "float64", "int", "2d", "noncontig", "dc0", "q_not_pow2", "q512",
    "nm0", "nm_gt_q", "q1"])
def test_wrapper_rejects_bad_inputs(bad):
    t, dc, q, nm = 6, 4, 16, 4
    v = torch.from_numpy(make_rows(t, dc, q, nm, "uniform"))
    err = ValueError
    if bad == "float64":
        v, err = v.double(), TypeError
    elif bad == "int":
        v, err = v.int(), TypeError
    elif bad == "2d":
        v = v.reshape(t * dc, q)
    elif bad == "noncontig":
        v = v.transpose(0, 1)
    elif bad == "dc0":
        v = v[:, :0].contiguous()
    elif bad == "q_not_pow2":
        v = v[..., :12].contiguous()
    elif bad == "q512":
        v = torch.zeros((t, dc, 512))
    elif bad == "nm0":
        nm = 0
    elif bad == "nm_gt_q":
        nm = q + 1
    elif bad == "q1":
        v, nm = torch.zeros((t, dc, 1)), 1
    with pytest.raises(err):
        cuda_cn.fb_checknode(v, nm)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version at small shapes (card only;
    chip_smoke.py runs the full-size comparison)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for t, dc, q, nm in [(300, 4, 256, 32), (101, 3, 16, 5), (33, 7, 64, 9)]:
        v = torch.from_numpy(make_rows(t, dc, q, nm, "ties")).cuda()
        before = cuda_cn.launches
        got = cuda_cn.fb_checknode(v, nm)
        assert cuda_cn.launches == before + 1
        assert torch.equal(got, tmc.fb_checknode_topk(v, nm))
