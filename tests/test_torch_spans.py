"""The batch step's spans and the decoder's marker kernels, on the CPU.

* One ``MonteCarlo.step`` under ``utils/timing.trace`` writes every
  ``nbldpc.*`` host range of the step, nested and in order; ``nbldpc.step``
  carries the batch index.  (``nbldpc.capture`` opens only where the device
  loop captures its graph, on the card.)
* Every decoder step reaches the marker launcher once for ``decide`` and
  once for ``syndrome``, and a layered decoder's step first once for
  ``sweep``, while a capture is under way (faked here: the flag
  ``device_loop.capturing``), and never outside one: on the CPU neither a
  step nor a whole batch launches a marker, with or without a profiler.
  On the card a marker outside a capture launches only while a profiler
  records.
* Counters, decisions, iteration counts and flags are the same with a
  profiler recording and without one.
* ``nbldpc.allreduce`` holds both all-reduces of a sharded step, on two
  gloo ranks.
"""
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ems_nbldpc_torch.decoder import device_loop
from ems_nbldpc_torch.decoder.api import DecoderConfig, decode
from ems_nbldpc_torch.decoder.flooding import make_flooding_stepper
from ems_nbldpc_torch.decoder.layered import (make_layered_compressed_stepper,
                                              make_layered_list_stepper,
                                              make_layered_stepper)
from ems_nbldpc_torch.models.code import random_regular
from ems_nbldpc_torch.parallel import mesh as pmesh
from ems_nbldpc_torch.sim.mc import MonteCarlo, SimConfig
from ems_nbldpc_torch.utils import timing

F = 8
STEPS = 3
DECODERS = {  # name -> (GF, decoder fields, stepper(graph, decoder config))
    "layered dense": (16, dict(cn="minsum", nm=0), lambda g, d: (
        make_layered_stepper(g, d.nm, d.offset, d.cn, d.cn_impl))),
    "list": (16, dict(cn="ems", nm=8, storage="compressed", nboper=16),
             lambda g, d: make_layered_list_stepper(
                 g, d.nm, d.offset, d.nboper, torch.float32)),
    "compressed": (16, dict(cn="ems", nm=8, storage="compressed",
                            cn_impl="topk"),
                   lambda g, d: make_layered_compressed_stepper(
                       g, d.nm, d.offset, torch.float32)),
    "flooding": (16, dict(schedule="flooding", cn="minsum", nm=0),
                 lambda g, d: make_flooding_stepper(
                     g, d.nm, d.offset, d.cn, d.cn_impl)),
}
GEN = ["nbldpc.seed", "nbldpc.encode", "nbldpc.channel"]
LOOP = ["nbldpc.reset", "nbldpc.launch", "nbldpc.readout"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread for these small decodes: the suite runs
    in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def launched(monkeypatch):
    """The markers that reach the launcher, by name, in order."""
    names = []
    monkeypatch.setattr(device_loop, "_launch_mark",
                        lambda i, device: names.append(device_loop.MARKS[i]))
    return names


def sim(name, ebn0=1.0):
    q, fields, _ = DECODERS[name]
    cfg = SimConfig(ebn0_db=ebn0, frames_per_batch=F,
                    decoder=DecoderConfig(max_iters=6, offset=0.3, **fields))
    return MonteCarlo(random_regular(48, 24, q, seed=3), cfg, device="cpu")


def ranges(trace_dir):
    """The trace's ``nbldpc.*`` ranges as (start, end, name), by start."""
    (path,) = [os.path.join(trace_dir, p) for p in os.listdir(trace_dir)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("name", "").startswith("nbldpc.") and "dur" in e)


def children(spans, parent):
    """The names of the ranges inside ``parent``, in order."""
    a, b, _ = parent
    return [n for s, e, n in spans if a <= s and e <= b and (s, e) != (a, b)]


@pytest.mark.parametrize("name", DECODERS)
def test_step_spans_nest_in_order(name, tmp_path, monkeypatch, launched):
    mc = sim(name)
    mc.step(0)
    args = {}
    record = torch.profiler.record_function

    def keep(label, arg=None):
        args[label] = arg
        return record(label, arg)

    monkeypatch.setattr(torch.profiler, "record_function", keep)
    with timing.trace(str(tmp_path)):
        mc.step(5)
    spans = ranges(str(tmp_path))
    (step,) = [s for s in spans if s[2] == "nbldpc.step"]
    assert args["nbldpc.step"] == "5"
    top = [n for n in children(spans, step)
           if n in ("nbldpc.gen", "nbldpc.decode", "nbldpc.count")]
    assert top == ["nbldpc.gen", "nbldpc.decode", "nbldpc.count"]
    (gen,) = [s for s in spans if s[2] == "nbldpc.gen"]
    assert children(spans, gen) == GEN
    (dec,) = [s for s in spans if s[2] == "nbldpc.decode"]
    # the compressed dense-CN decoder runs the host loop, without the
    # device loop's spans
    assert children(spans, dec) == ([] if name == "compressed" else LOOP)
    assert children(spans, step) == (
        ["nbldpc.gen"] + GEN + ["nbldpc.decode"]
        + children(spans, dec) + ["nbldpc.count"])
    assert launched == []


@pytest.mark.parametrize("name", DECODERS)
def test_markers_once_a_step_in_a_capture(name, monkeypatch, launched):
    mc = sim(name)
    _, intr = mc.gen(0)
    init_fn, step_fn = DECODERS[name][2](mc.graph, mc.cfg.decoder)
    state = init_fn(intr.to(torch.float32))
    for _ in range(STEPS):
        state = step_fn(state)
    with profile(activities=[ProfilerActivity.CPU]):
        state = step_fn(state)
    assert launched == []
    monkeypatch.setattr(device_loop, "capturing", True)
    for _ in range(STEPS):
        state = step_fn(state)
    head = [] if name == "flooding" else ["sweep"]
    assert launched == (head + ["decide", "syndrome"]) * STEPS


@pytest.mark.parametrize("name", DECODERS)
def test_profiler_changes_no_result(name, tmp_path, launched):
    mc = sim(name)
    _, intr = mc.gen(2)
    plain = [mc.step(b)[0] for b in range(3)], decode(mc.graph, intr,
                                                      mc.cfg.decoder)
    with timing.trace(str(tmp_path)):
        traced = [mc.step(b)[0] for b in range(3)], decode(mc.graph, intr,
                                                           mc.cfg.decoder)
    for a, b in zip(plain[0] + list(plain[1]), traced[0] + list(traced[1])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a decode with frames left at the budget: the steps did run
    assert int(plain[0][0][5]) > 1
    assert launched == []


def test_eager_markers_only_on_the_card_while_recording(launched):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    device_loop.mark("encode", cuda)
    device_loop.mark("decide", cpu)
    assert launched == []
    assert not timing.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing.recording()
        device_loop.mark("encode", cuda)
        device_loop.mark("syndrome", cpu)
        with timing.span("x") as s:
            assert s is not None
    assert launched == ["encode"]
    assert timing.span("x") is timing.span("y")


def allreduce_rank(out):
    """One sharded step under the profiler; rank 0 writes the
    ``nbldpc.allreduce`` ranges and the all-reduce calls inside them."""
    mesh = pmesh.make_mesh(2, devices="cpu")
    cfg = SimConfig(ebn0_db=2.0, frames_per_batch=F,
                    decoder=DecoderConfig(max_iters=4, cn="minsum"))
    step = pmesh.sharded_batch_step(random_regular(48, 24, 16, seed=3), cfg,
                                    mesh)
    step(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = step(1)
    events = [(e.time_range.start, e.time_range.end, e.name)
              for e in prof.events()]
    spans = [e for e in events if e[2] == "nbldpc.allreduce"]
    calls = [n for s, e, n in events
             if n == "c10d::allreduce_"
             and any(a <= s and e <= b for a, b, _ in spans)]
    outside = [n for s, e, n in events
               if n == "c10d::allreduce_"
               and not any(a <= s and e <= b for a, b, _ in spans)]
    if mesh.rank == 0:
        with open(out, "w") as f:
            json.dump({"spans": len(spans), "inside": len(calls),
                       "outside": len(outside),
                       "frames": int(got[0])}, f)


def test_allreduce_span_holds_both_reductions(tmp_path):
    out = str(tmp_path / "rank0.json")
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        pmesh.launch(2, allreduce_rank, (out,), devices="cpu", timeout=60.0,
                     join_timeout=180.0)
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old
    with open(out) as f:
        rec = json.load(f)
    assert rec == {"spans": 1, "inside": 2, "outside": 0, "frames": 2 * F}
