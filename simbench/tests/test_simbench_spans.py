"""The readers of the program's marker spans (``encode_ms``, ``channel_ms``,
``decide_ms``, ``syndrome_ms``) on synthetic traces laid out as the card
runs a batch: gen's markers and kernels, the harness's ``index_select``,
the decode's eager reset, then the device loop's graph (``set_condition``,
then each step's kernels, decide and syndrome markers and its closing
``set_condition``)."""
import numpy as np
import pytest

from simbench.metrics import reader

MARK = "(anonymous namespace)::nbldpc_mark_{}()"
COND = "(anonymous namespace)::set_condition(unsigned long long, bool const*)"
# per batch, us: encoder, channel, kept frames, reset, CN step, decisions,
# syndrome
ENC, CHAN, KEEP, RESET = 400.0, 150.0, 7.0, 90.0
CN, DEC, SYN = 300.0, 80.0, 20.0


def _batch(kernels, t, steps):
    def k(name, dur):
        nonlocal t
        kernels.append((t, dur, name))
        t += dur

    k(MARK.format("encode"), 1.0)
    k("sm80_xmma_gemm_f32f32", ENC - 1.0)
    k(MARK.format("channel"), 1.0)
    k("elementwise_kernel", CHAN - 1.0)
    k(MARK.format("end"), 1.0)
    k("index_elementwise_kernel index_select", KEEP)     # the harness's
    k("reduce_kernel ArgMin", RESET)                    # the reset's argmin
    k(COND, 1.0)
    for _ in range(steps):
        k("spa_row_kernel", CN)
        k(MARK.format("decide"), 1.0)
        k("reduce_kernel ArgMin", DEC - 1.0)
        k(MARK.format("syndrome"), 1.0)
        k("reduce_kernel xor", SYN - 2.0)
        k(COND, 1.0)
    k("count", 50.0)
    return t + 500.0                                    # the host's gap


def _run(iters, drop=None, nth=0):
    """The trace of ``iters``' batches, without the ``nth`` kernel named
    ``drop`` (a marker's name, or the full name of another kernel)."""
    kernels, t = [], 0.0
    for it in iters:
        t = _batch(kernels, t, int(it.max()))
    if drop is not None:
        name = MARK.format(drop) if "(" not in drop else drop
        at = [i for i, (_, _, n) in enumerate(kernels) if n == name][nth]
        del kernels[at]
    return {"profile": {"kernels": kernels, "iters": iters}}


ITERS = [np.array([1, 4, 2, 0]), np.array([3, 3, 1, 1]),
         np.array([6, 1, 1, 2])]


def test_each_reader_gives_ms_a_batch():
    run = _run(ITERS)
    steps = sum(int(it.max()) for it in ITERS)
    assert reader("encode_ms")(run) == pytest.approx(ENC / 1e3)
    assert reader("channel_ms")(run) == pytest.approx(CHAN / 1e3)
    assert reader("decide_ms")(run) == pytest.approx(
        steps * DEC / 1e3 / len(ITERS))
    assert reader("syndrome_ms")(run) == pytest.approx(
        steps * (SYN - 1.0) / 1e3 / len(ITERS))


def test_channel_leaves_out_the_harness_and_decide_the_reset():
    run = _run(ITERS[:1])
    # the index_select after nbldpc_mark_end is not the channel's; the
    # eager reset's argmin before the graph is not the decisions'
    assert reader("channel_ms")(run) * 1e3 == pytest.approx(CHAN)
    assert reader("decide_ms")(run) * 1e3 == pytest.approx(
        int(ITERS[0].max()) * DEC)


@pytest.mark.parametrize("name", ["encode_ms", "channel_ms", "decide_ms",
                                  "syndrome_ms"])
def test_no_markers_read_nothing(name):
    run = _run(ITERS)
    prof = run["profile"]
    prof["kernels"] = [k for k in prof["kernels"]
                       if "nbldpc_mark_" not in k[2]]
    assert reader(name)(run) is None
    assert reader(name)({"profile": None}) is None


def test_a_missing_decide_marker_is_not_read(capsys):
    run = _run(ITERS, drop="decide")
    assert reader("decide_ms")(run) is None
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "not read" in err[0]
    # the spans the trace holds whole are still read
    assert reader("encode_ms")(run) == pytest.approx(ENC / 1e3)
    assert reader("syndrome_ms")(run) == pytest.approx(
        reader("syndrome_ms")(_run(ITERS)))


def test_a_missing_end_marker_is_not_read(capsys):
    run = _run(ITERS, drop="end")
    assert reader("channel_ms")(run) is None
    assert "not read" in capsys.readouterr().err


def test_a_closing_kernel_lost_to_the_tracer():
    """The tracer lost the first step's set_condition of the stretch's
    first graph replay: that syndrome span is left out and the others'
    mean stands in for it (the steps' syndrome checks are the same work);
    a second loss in a batch is not read."""
    full = reader("syndrome_ms")(_run(ITERS))
    # the graph's head set_condition is the first, the first step's the
    # second
    run = _run(ITERS, drop=COND, nth=1)
    assert reader("syndrome_ms")(run) == pytest.approx(full)
    assert reader("decide_ms")(run) == pytest.approx(
        reader("decide_ms")(_run(ITERS)))
    run = _run(ITERS[:1], drop=COND, nth=1)
    prof = run["profile"]
    conds = [i for i, k in enumerate(prof["kernels"]) if k[2] == COND]
    del prof["kernels"][conds[1]]
    assert reader("syndrome_ms")(run) is None


def test_a_start_before_the_tracer_began():
    """The trace begins after the stretch's first encode marker: its
    span is left out and the others' mean stands in; the same marker
    missing from a later batch is a mismatch."""
    run = _run(ITERS)
    del run["profile"]["kernels"][:2]
    assert run["profile"]["kernels"][0][2] == MARK.format("channel")
    assert reader("encode_ms")(run) == pytest.approx(ENC / 1e3)
    assert reader("channel_ms")(run) == pytest.approx(CHAN / 1e3)
    assert reader("encode_ms")(_run(ITERS, drop="encode", nth=1)) is None
