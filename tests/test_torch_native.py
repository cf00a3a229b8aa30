"""The port's binding of the C++ core (``ems_nbldpc_torch/native.py``)
against the port's golden model and bubble decoder.

The core (``csrc/nbldpc_core.cpp``) is the C reference's layered 8-bubble
EMS decoder in f64.  It must equal the golden copy (its elementary step
within rtol 1e-12, whole decodes identically), and the port's f32 bubble
decode must decide alike on every frame both call converged (the core
never min-normalises CtoV and sums in f64, so frames that do not converge
may end elsewhere).  Needs ``g++``; nothing else of the machine.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from ems_nbldpc_torch import golden, native
from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.models.code import random_regular
from ems_nbldpc_torch.ops import _build
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is needed to build the C++ core")


def frames(code, f, ebn0, seed=0):
    """[f, N, q] float32 intrinsics of random codewords (the port's own
    encoder and BPSK channel on the CPU)."""
    cfg = SimConfig(ebn0_db=ebn0, frames_per_batch=f, encode="device",
                    seed=seed)
    cw, intr = MonteCarlo(code, cfg, device="cpu").gen(0)
    return cw.numpy(), intr.numpy()


def test_builds_into_the_package_build_dir_and_leaves_csrc_alone():
    csrc = os.path.dirname(native.SOURCE)

    def sources():
        return {n: os.stat(os.path.join(csrc, n)).st_mtime_ns
                for n in ("nbldpc_core.cpp", "Makefile")}

    before = sources()
    lib, _ = native.build()
    assert os.path.dirname(lib) == _build.BUILD_DIR
    assert os.path.basename(lib).startswith("libnbldpc_")
    assert sources() == before
    # nothing of the port's build lands in csrc/ (the JAX package's own
    # Makefile may put its libnbldpc.so there)
    assert not [n for n in os.listdir(csrc) if n.startswith("libnbldpc_")]
    assert native.build() == (lib, 0.0)        # cached by digest


@pytest.mark.parametrize("q,nm", [(64, 16), (256, 32)])
def test_elementary_step_matches_golden(q, nm):
    rng = np.random.default_rng(q)
    for _ in range(30):
        v1 = np.sort(rng.random(nm) * 5)
        v2 = np.sort(rng.random(nm) * 5)
        g1 = rng.permutation(q)[:nm]
        g2 = rng.permutation(q)[:nm]
        for nb_oper in (nm // 2, 2 * nm, 4 * nm):
            gv, gg = golden.elementary_bubble(v1, g1, v2, g2, nm, nb_oper)
            nv, ng = native.elementary_step(q, v1, g1, v2, g2, nm, nb_oper)
            np.testing.assert_allclose(nv, gv, rtol=1e-12)
            np.testing.assert_array_equal(ng, gg)


@pytest.mark.parametrize("q,nm,nb_oper", [(16, 8, 16), (64, 16, 32)])
def test_decode_matches_golden_on_noisy_frames(q, nm, nb_oper):
    code = random_regular(48, 24, q, seed=1)
    _, intr = frames(code, 12, 1.0, seed=q)
    nd, ni, nc = native.decode_batch(code, intr, 10, nm, 0.3, nb_oper)
    for f in range(len(intr)):
        gd, gi, gc = golden.decode_layered_golden(
            code, intr[f].astype(np.float64), 10, nm, 0.3, nb_oper)
        assert (gc, gi) == (bool(nc[f]), int(ni[f])), f
        np.testing.assert_array_equal(nd[f], gd, err_msg=str(f))
    assert ni.max() > 1 and nc.any(), "uninformative batch"


def test_port_bubble_decode_agrees_with_the_core_where_both_converge():
    code = random_regular(96, 48, 64, seed=2)
    cw, intr = frames(code, 24, 2.0, seed=5)
    nm, nb_oper = 16, 32
    cfg = DecoderConfig(max_iters=10, schedule="layered", cn="ems", nm=nm,
                        offset=0.3, cn_impl="bubble", nboper=nb_oper,
                        loop="host")
    d, _, conv = (x.numpy() for x in decode(code, torch.from_numpy(intr),
                                            cfg))
    nd, _, nc = native.decode_batch(code, intr, 10, nm, 0.3, nb_oper)
    both = conv & nc
    assert both.sum() >= len(intr) // 2, (conv, nc)
    np.testing.assert_array_equal(d[both], nd[both])
    np.testing.assert_array_equal(d[both], cw[both])
