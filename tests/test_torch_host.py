"""The port's NumPy host layer against the JAX package's, and its import
boundary.  Everything here is integer/GF/structure logic: exact equality."""
import os
import subprocess
import sys

import numpy as np
import pytest

import ems_nbldpc_tpu.models.encoder as jenc_mod
from ems_nbldpc_tpu.decoder.graph import DeviceGraph as JGraph
from ems_nbldpc_tpu.gf import get_gf as jget_gf
from ems_nbldpc_tpu.models import code as jcode_mod
from ems_nbldpc_tpu.models import formats as jformats

import ems_nbldpc_torch.models.encoder as tenc_mod
from ems_nbldpc_torch.decoder.graph import DeviceGraph as TGraph
from ems_nbldpc_torch.decoder.graph import rotation_table
from ems_nbldpc_torch.gf import get_gf as tget_gf
from ems_nbldpc_torch.models import code as tcode_mod
from ems_nbldpc_torch.models import formats as tformats
from ems_nbldpc_torch.models.code import from_jax_code
from ems_nbldpc_torch.models.encoder import from_jax_encoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UBS = os.path.join(REPO, "benchmarks", "results_r2", "rand48_gf256.ubs")
CODE_ARRAYS = ("row_cols", "row_coefs", "row_deg", "col_deg", "edge_row",
               "edge_col", "edge_coef", "col_edges", "row_edges")
SHAPES = [(48, 24, 64), (64, 32, 256)]


@pytest.fixture
def fresh_caches(tmp_path, monkeypatch):
    """Both encoders compute from scratch into a private cache."""
    monkeypatch.setattr(jenc_mod, "CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(tenc_mod, "CACHE_DIR", str(tmp_path / "torch"))


def assert_same_code(jc, tc):
    assert (jc.q, jc.n, jc.m_rows) == (tc.q, tc.n, tc.m_rows)
    for name in CODE_ARRAYS:
        np.testing.assert_array_equal(getattr(jc, name), getattr(tc, name),
                                      err_msg=name)
    assert len(jc.layers) == len(tc.layers)
    for a, b in zip(jc.layers, tc.layers):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("q", [4, 8, 16, 32, 64, 128, 256])
def test_gf_tables_identical(q):
    j, t = jget_gf(q), tget_gf(q)
    for name in ("exp", "log", "power_to_poly", "poly_to_power",
                 "mul_table", "xor_table"):
        np.testing.assert_array_equal(getattr(j, name), getattr(t, name))
    a = np.arange(1, q)
    np.testing.assert_array_equal(j.inv(a), t.inv(a))
    np.testing.assert_array_equal(j.bits(np.arange(q)), t.bits(np.arange(q)))


@pytest.mark.parametrize("n,m,q", SHAPES)
def test_random_regular_identical(n, m, q):
    jc = jcode_mod.random_regular(n, m, q, seed=3)
    tc = tcode_mod.random_regular(n, m, q, seed=3)
    assert_same_code(jc, tc)
    assert tcode_mod.COLORING_VERSION == jcode_mod.COLORING_VERSION


def test_from_parsed_ubs_identical():
    jc = jcode_mod.from_parsed(jformats.parse(UBS))
    tc = tcode_mod.from_parsed(tformats.parse(UBS))
    assert_same_code(jc, tc)


@pytest.mark.parametrize("n,m,q", SHAPES)
def test_rotation_plan_identical(n, m, q):
    """Each position's gather row equals the lane permutation of its group
    in the JAX RotationPlan (per edge, and per row slot with padding)."""
    jc = jcode_mod.random_regular(n, m, q, seed=4)
    jg, tg = JGraph.from_code(jc), TGraph.from_code(from_jax_code(jc))
    for jp, coefs in ((jg.rotplan, tg.code.edge_coef),
                      (jg.rows_rotplan, tg.code.row_coefs)):
        for direction, perms in (("in", jp.perm_in), ("out", jp.perm_out)):
            want = np.zeros((coefs.size, q), np.int64)
            for (s, e), perm in zip(jp.bounds, perms):
                want[jp.sort_idx[s:e]] = perm
            np.testing.assert_array_equal(
                rotation_table(coefs, tg.code.gf, direction), want)
    np.testing.assert_array_equal(jg.row_edges, tg.row_edges)
    for a, b in zip(jg.layers, tg.layers):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,m,q", SHAPES)
def test_encoder_identical(n, m, q, fresh_caches):
    jc = jcode_mod.random_regular(n, m, q, seed=5)
    tc = from_jax_code(jc)
    je = jenc_mod.gaussian_elimination(jc)
    te = tenc_mod.gaussian_elimination(tc)
    np.testing.assert_array_equal(je.mat_ut, te.mat_ut)
    np.testing.assert_array_equal(je.perm, te.perm)
    np.testing.assert_array_equal(je.bit_generator, te.bit_generator)
    # the on-disk cache round-trips to the same encoder
    again = tenc_mod.gaussian_elimination(tc)
    np.testing.assert_array_equal(again.mat_ut, te.mat_ut)
    np.testing.assert_array_equal(again.perm, te.perm)
    info = np.random.default_rng(0).integers(0, q, (4, tc.k))
    cw = te.encode_np(info)
    np.testing.assert_array_equal(cw, je.encode_np(info))
    assert (tenc_mod.syndrome_np(tc, cw) == 0).all()


def test_from_jax_roundtrip(fresh_caches):
    jc = jcode_mod.random_regular(48, 24, 64, seed=6, name="rt")
    tc = from_jax_code(jc)
    assert tc.name == "rt"
    assert_same_code(jc, tc)
    assert_same_code(jc, from_jax_code(tc))   # port -> port is the identity
    je = jenc_mod.gaussian_elimination(jc)
    te = from_jax_encoder(je)
    assert_same_code(jc, te.code)
    np.testing.assert_array_equal(te.mat_ut, je.mat_ut)
    np.testing.assert_array_equal(te.perm, je.perm)
    te2 = from_jax_encoder(je, code=tc)
    assert te2.code is tc
    np.testing.assert_array_equal(te2.bit_generator, je.bit_generator)


def test_port_imports_no_jax():
    script = (
        "import importlib, pkgutil, sys\n"
        "import ems_nbldpc_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 15, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ems_nbldpc_tpu')))\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
