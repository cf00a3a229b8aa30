"""The harness's run without its look for a card, on a small code on the
CPU, sound and with the timed path broken underneath: ``correct`` has to
come out false for each fault the cells can have."""
import os
import time

import pytest
import torch

from simbench import cellrun, run, sharded, spec

SPA = dict(max_iters=10, schedule="layered", cn="spa", nm=0, offset=0.3,
           nboper=0, cn_impl="auto", loop="device", storage="dense",
           dtype="float32")
LIST = dict(max_iters=8, schedule="layered", cn="ems", nm=8, offset=0.3,
            nboper=16, cn_impl="auto", loop="device", storage="compressed",
            dtype="bfloat16")
LIMITS = dict(codewords_wrong=0, intrinsic_rel_err=1e-6, decode_differ_pct=0,
              counters_wrong=0, batch_frames_wrong=0, exchange_wrong=0)


def tiny_cell(dec, ref, chips=1):
    config = dict(name="tiny", frames_per_batch=8, encode="device",
                  decoder=dec, kernels=[], reference=ref, check=LIMITS,
                  code=dict(kind="random_regular", n=96, m=48, q=16, dv=2,
                            seed=1))
    return dict(name="tiny.cell", chips=chips, config=config,
                traffic=dict(channel="bpsk", ebn0_db=1.5, ranks=chips,
                             pool_seed=5, pool_batches=6),
                end_to_end=[], per_layer=[])


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def verdict(cell, seconds=0.6, seed=2 ** 31 + 11):
    rec = cellrun.run_rank(cell, seed, seconds, False, "cpu",
                           time.perf_counter())
    assert len(rec["window"]["walls"]) >= 2
    correct, numbers, _ = run.judge(cell, [rec])
    return correct, numbers


@pytest.mark.parametrize("dec,ref", [(SPA, "spa"), (LIST, "list_ems")])
def test_sound_run_is_correct(dec, ref):
    correct, numbers = verdict(tiny_cell(dec, ref))
    assert correct, numbers


@pytest.mark.parametrize("dec,ref", [(SPA, "spa"), (LIST, "list_ems")])
def test_step_that_returns_its_state_unchanged(monkeypatch, dec, ref):
    from ems_nbldpc_torch.decoder import device_loop

    def frozen(self):
        self.it += 1
        self._update_pred()

    monkeypatch.setattr(device_loop.DeviceLoop, "_step", frozen)
    correct, numbers = verdict(tiny_cell(dec, ref))
    assert not correct and numbers["decode_differ_pct"] > 0


def test_half_the_batch_left_out(monkeypatch):
    from ems_nbldpc_torch.sim.mc import MonteCarlo

    count = MonteCarlo.count

    def half(self, decide, cw, iters, conv):
        h = decide.shape[0] // 2
        return count(self, decide[:h], cw[:h], iters[:h], conv[:h])

    monkeypatch.setattr(MonteCarlo, "count", half)
    correct, numbers = verdict(tiny_cell(SPA, "spa"))
    assert not correct
    assert numbers["batch_frames_wrong"] > 0 and numbers["counters_wrong"] > 0


def test_decision_altered_where_produced(monkeypatch):
    from ems_nbldpc_torch.sim import mc

    decode = mc.decode

    def altered(*args):
        d, it, cv = decode(*args)
        d = d.clone()
        d[3, 5] ^= 1
        return d, it, cv

    monkeypatch.setattr(mc, "decode", altered)
    correct, numbers = verdict(tiny_cell(LIST, "list_ems"))
    assert not correct and numbers["decode_differ_pct"] > 0


def test_codeword_altered_where_produced(monkeypatch):
    from ems_nbldpc_torch.sim.mc import MonteCarlo

    gen = MonteCarlo.gen

    def altered(self, batch_idx):
        cw, intr = gen(self, batch_idx)
        cw = cw.clone()
        cw[0, 0] ^= 1
        return cw, intr

    monkeypatch.setattr(MonteCarlo, "gen", altered)
    correct, numbers = verdict(tiny_cell(SPA, "spa"))
    assert not correct and numbers["codewords_wrong"] > 0


def test_intrinsic_altered_where_produced(monkeypatch):
    from ems_nbldpc_torch.sim import mc

    simulate = mc.simulate

    def altered(*args):
        intr = simulate(*args)
        return intr * (1 + 1e-4)

    monkeypatch.setattr(mc, "simulate", altered)
    correct, numbers = verdict(tiny_cell(SPA, "spa"))
    assert not correct and numbers["intrinsic_rel_err"] > 1e-6


@pytest.mark.parametrize("dec,ref,config", [
    (SPA, "spa", "dvbt2_gf256_spa"), (LIST, "list_ems", "dvbt2_gf256_list_ems")])
def test_control_in_the_programs_place_is_not_correct(dec, ref, config):
    """The control (the reference one precision step below the
    configuration's) through the run's own comparison, ``finish`` and
    ``verdict``, under the configuration's limits: not correct."""
    cell = tiny_cell(dec, ref)
    limits = spec.load_json(os.path.join(spec.HERE, "configs",
                                         f"{config}.json"))["check"]
    cell["config"]["check"] = limits
    rec = cellrun.run_rank(cell, 2 ** 31 + 11, 0.6, False, "cpu",
                           time.perf_counter(), control=True)
    correct, numbers, _ = run.judge(cell, [rec])
    assert not correct, numbers
    assert numbers["intrinsic_rel_err"] > limits["intrinsic_rel_err"]
    assert numbers["counters_wrong"] == numbers["codewords_wrong"] == 0


def _ranks(cell, fault):
    return sharded.run_ranks(cell, 2 ** 31 + 5, 0.8, False, "cpu",
                             time.time(), join_timeout=240,
                             rank_fn=fault)


def test_sharded_run_is_correct():
    recs = _ranks(tiny_cell(SPA, "spa", chips=2), None)
    correct, numbers, _ = run.judge(tiny_cell(SPA, "spa", chips=2), recs)
    assert correct, numbers
    assert numbers["exchange_wrong"] == 0


def rank_without_exchange(*args):
    """A rank whose counters skip the all-reduce."""
    from ems_nbldpc_torch.parallel import mesh

    mesh._all_reduce = lambda counters, groups: counters.clone()
    sharded._rank(*args)


def test_exchange_between_ranks_left_out():
    cell = tiny_cell(SPA, "spa", chips=2)
    recs = _ranks(cell, rank_without_exchange)
    correct, numbers, _ = run.judge(cell, recs)
    assert not correct
    assert numbers["exchange_wrong"] > 0 and numbers["batch_frames_wrong"] > 0
