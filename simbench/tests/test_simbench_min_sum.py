"""The min-sum configuration on the CPU: its plain reference against the
port's CPU path (the torch check node in K1's place) on small codes, its
control through the run's own comparison, K1's bound, the configuration
and its cells as ``spec`` loads them, and the readers of K1's roofline
share and of the sweep around K1 on synthetic traces."""
import os
import time

import numpy as np
import pytest
import torch

from simbench import cellrun, run, spec
from simbench.bounds import ems_dense
from simbench.metrics import reader
from simbench.reference import channel, encoder, min_sum
from simbench.tests.test_simbench_faults import tiny_cell
from simbench.tests.test_simbench_reference import SMALL, _port_batch, small

CONFIG = spec.load_json(os.path.join(spec.HERE, "configs",
                                     "dvbt2_gf256_min_sum.json"))
DEC = CONFIG["decoder"]
CELLS = ("min_sum_row.1p8dB", "spa_row.4card")


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_the_configuration_is_the_decoders_defaults():
    from ems_nbldpc_torch.decoder.api import DecoderConfig

    fields = DecoderConfig.__dataclass_fields__
    assert DEC == {k: fields[k].default for k in DEC}
    assert CONFIG["reference"] == "min_sum"
    assert CONFIG["decoder"]["max_iters"] == 10


@pytest.mark.parametrize("ebn0", [1.0, 1.5])
@pytest.mark.parametrize("n,m,q,seed", SMALL[:2])
def test_batch_equals_the_ports_cpu_path(n, m, q, seed, ebn0):
    """Decisions, iteration counts and convergence flags of one batch, bit
    for bit: the port's CPU path runs ``ems_rows``' plain version, which
    K1 matches bit for bit, and the reference's chains associate as its
    merges do."""
    frames = 12
    cw, intr, (d, it, cv) = _port_batch(n, m, q, seed, DEC, ebn0, frames)
    _, _, code = small(n, m, q, seed)
    sig = channel.sigma(ebn0, code.k / code.n)
    g_info, g_chan = channel.generators(77, 3, "cpu")
    logq = q.bit_length() - 1
    info = encoder.info_symbols(
        channel.info_bits(g_info, frames, code.k, logq, "cpu"), code.k, logq)
    assert not encoder.wrong_codewords(code, encoder.information_set(code),
                                       cw, info).any()
    want = channel.intrinsic(channel.received(g_chan, cw, q, sig), q, sig)
    assert torch.equal(want, intr)
    rd, rit, rcv = min_sum.decode(code, want, DEC, block=5)
    assert torch.equal(rd, d) and torch.equal(rit, it.to(rit.dtype))
    assert torch.equal(rcv, cv)
    assert int(it.max()) >= 3              # the decode did work


def test_minconv_is_the_min_over_all_pairs():
    g = torch.Generator().manual_seed(3)
    a, b = torch.rand(5, 16, generator=g), torch.rand(5, 16, generator=g)
    s = torch.arange(16)
    got = min_sum.minconv(a, b, s[:, None] ^ s[None, :])
    want = torch.full_like(a, float("inf"))
    for x in range(16):
        for y in range(16):
            want[:, x ^ y] = torch.minimum(want[:, x ^ y], a[:, x] + b[:, y])
    assert torch.equal(got, want)


def test_rejects_what_it_does_not_decode():
    _, _, code = small(96, 48, 16, 1)
    intr = torch.zeros(2, 96, 16)
    for bad in (dict(nm=8), dict(dtype="bfloat16"), dict(storage="compressed"),
                dict(cn="spa"), dict(cn_impl="bubble")):
        with pytest.raises(ValueError):
            min_sum.decode(code, intr, dict(DEC, **bad))


def test_control_comes_out_not_correct():
    """bfloat16 storage of APP and CtoV changes the decode of many frames
    of a small code, where the limit allows none."""
    _, _, code = small(384, 192, 64, 1)
    cw = torch.zeros((32, 384), dtype=torch.int64)
    g = channel.generators(5, 0, "cpu")[1]
    sig = channel.sigma(1.5, code.k / code.n)
    intr = channel.intrinsic(channel.received(g, cw, 64, sig), 64, sig)
    d, it, cv = min_sum.decode(code, intr, DEC)
    dc, itc, cvc = min_sum.decode(code, intr, DEC, control=True)
    differ = ((d != dc).any(1) | (it != itc) | (cv != cvc)).float().mean()
    assert 100 * float(differ) > CONFIG["check"]["decode_differ_pct"] + 5


def test_sound_run_is_correct():
    correct, numbers, _ = _judge(tiny_cell(DEC, "min_sum"), control=False)
    assert correct, numbers
    assert numbers["decode_differ_pct"] == 0


def test_control_in_the_programs_place_is_not_correct():
    """The control through the run's own comparison, ``finish`` and
    ``verdict``, under the configuration's limits: not correct."""
    cell = tiny_cell(DEC, "min_sum")
    cell["config"]["check"] = CONFIG["check"]
    correct, numbers, _ = _judge(cell, control=True)
    assert not correct, numbers
    assert numbers["intrinsic_rel_err"] > CONFIG["check"]["intrinsic_rel_err"]
    assert numbers["decode_differ_pct"] > CONFIG["check"]["decode_differ_pct"]
    assert numbers["counters_wrong"] == numbers["codewords_wrong"] == 0


def _judge(cell, control):
    rec = cellrun.run_rank(cell, 2 ** 31 + 11, 0.6, False, "cpu",
                           time.perf_counter(), control=control)
    assert len(rec["window"]["walls"]) >= 2
    return run.judge(cell, [rec])


def test_k1_bound_at_128_frames():
    """Every frame active at F = 128: the dense merges' 1.36e11 sums and
    minima at 67 TFLOP/s, K1's dense-mode bound since its redesign."""
    assert ems_dense.bound_ms(128, 1350, 4, 256, CONFIG) == pytest.approx(
        2.0283, rel=5e-3)
    # the operations bound it, in proportion to the active frames
    assert ems_dense.bound_ms(64, 1350, 4, 256, CONFIG) == pytest.approx(
        ems_dense.bound_ms(128, 1350, 4, 256, CONFIG) / 2)


@pytest.mark.parametrize("name", CELLS)
def test_cells_load(name):
    cell = spec.cell(name)
    assert cell["traffic"]["ebn0_db"] == 1.8
    assert cell["traffic"].get("ranks", 1) == cell["chips"]
    names = {m["name"] for m in cell["per_layer"]}
    if name == "min_sum_row.1p8dB":
        assert cell["config"] == CONFIG and cell["chips"] == 1
        assert {"k1_roofline_pct", "ems_sweep_ms", "decide_ms"} <= names
    else:
        assert cell["config"]["name"] == "dvbt2_gf256_spa"
        assert cell["chips"] == 4 and cell["traffic"]["ranks"] == 4
        assert "k1_roofline_pct" not in names


MARK = "(anonymous namespace)::nbldpc_mark_{}()"
COND = "(anonymous namespace)::set_condition(unsigned long long, bool const*)"
K1 = "void (anonymous namespace)::ems_rows_kernel<256, true>(Params)"
GATHER, K1_US, SCATTER, DEC_US = 40.0, 300.0, 25.0, 30.0


def _trace(iters, layers=3, sweep=True):
    kernels, t = [], 0.0

    def k(name, dur):
        nonlocal t
        kernels.append((t, dur, name))
        t += dur

    for it in iters:
        k(MARK.format("encode"), 1.0)
        k("gemm", 100.0)
        k(COND, 1.0)
        for _ in range(int(it.max())):
            if sweep:
                k(MARK.format("sweep"), 1.0)
            for _ in range(layers):
                k("index_elementwise_kernel", GATHER)
                k(K1, K1_US)
                k("index_put_kernel", SCATTER)
            k(MARK.format("decide"), 1.0)
            k("decide_kernel", DEC_US - 1.0)
            k(MARK.format("syndrome"), 1.0)
            k("xor", 10.0)
            k(COND, 1.0)
        t += 500.0
    return {"profile": {"kernels": kernels, "iters": iters},
            "config": CONFIG, "shape": {"layers": [1350] * layers, "dc": 4,
                                        "q": 256}}


ITERS = [np.array([1, 4, 2, 0]), np.array([3, 3, 1, 1])]


def test_sweep_less_k1_a_batch():
    steps = sum(int(it.max()) for it in ITERS)
    per_step = 1.0 + 3 * (GATHER + SCATTER)         # the marker's own 1 us
    assert reader("ems_sweep_ms")(_trace(ITERS)) == pytest.approx(
        steps * per_step / 1e3 / len(ITERS))
    # decisions are read as before, the sweep marker outside their span
    assert reader("decide_ms")(_trace(ITERS)) == pytest.approx(
        steps * DEC_US / 1e3 / len(ITERS))


def test_sweep_start_before_the_tracer_and_a_lost_marker(capsys):
    """The trace begins inside the stretch's first sweep: that span is left
    out and the others' mean stands in (``_marks``' rule); a decide marker
    missing mid-stretch is a mismatch, and a program without the sweep
    marker reads nothing."""
    full = reader("ems_sweep_ms")(_trace(ITERS))
    run_rec = _trace(ITERS)
    kernels = run_rec["profile"]["kernels"]
    first = next(i for i, k in enumerate(kernels)
                 if k[2] == MARK.format("decide"))
    del kernels[:first]
    assert reader("ems_sweep_ms")(run_rec) == pytest.approx(full)
    assert "stands in" in capsys.readouterr().err
    run_rec = _trace(ITERS)
    kernels = run_rec["profile"]["kernels"]
    at = [i for i, k in enumerate(kernels) if k[2] == MARK.format("decide")]
    del kernels[at[2]]
    assert reader("ems_sweep_ms")(run_rec) is None
    assert "not read" in capsys.readouterr().err
    assert reader("ems_sweep_ms")(_trace(ITERS, sweep=False)) is None
    assert reader("ems_sweep_ms")({"profile": None}) is None


def test_k1_roofline_at_the_active_frames():
    rec = _trace(ITERS)
    bound = sum(ems_dense.bound_ms(int((it > s).sum()), 1350, 4, 256, CONFIG)
                for it in ITERS for s in range(int(it.max())) for _ in "abc")
    launches = 3 * sum(int(it.max()) for it in ITERS)
    assert reader("k1_roofline_pct")(rec) == pytest.approx(
        100 * bound / (launches * K1_US / 1e3))
    assert reader("k2_roofline_pct")(rec) is None
