"""Monte-Carlo FER/BER harness on torch tensors.

Port of ``ems_nbldpc_tpu/sim/mc.py``: per batch, codeword + channel
generation on the device, the decode, then the error counters; the host
accumulates scalar counters and applies the stop-at-K-erroneous-frames rule
(reference ``NB_LDPC.c:250-511``).  With the default ``loop="device"`` the
decode is one replay of a captured CUDA graph (``decoder/device_loop``),
the counterpart of the JAX package's fused batch step; generation and
counting stay eager, so each batch keeps its own seeded generators.

Randomness: batch ``b`` draws its info bits and its noise from two
``torch.Generator``s on the device, seeded from ``(SimConfig.seed, b)``
through ``numpy.random.SeedSequence`` (the counterpart of
``jax.random.fold_in``).  The streams differ from JAX's, so the two
packages agree in FER distribution, not frame by frame.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..decoder.api import DecoderConfig, decode
from ..decoder.device_loop import mark
from ..decoder.graph import DeviceGraph
from ..models.channels import ChannelSpec, simulate
from ..models.code import COLORING_VERSION, NBCode
from ..models.encoder import Encoder, gaussian_elimination
from ..utils.stats import wilson_ci
from ..utils.timing import span


@dataclasses.dataclass(frozen=True)
class SimConfig:
    ebn0_db: float
    frames_per_batch: int = 1024
    max_frames: int = 1_000_000
    stop_errors: int = 40          # NB_LDPC.c:506
    seed: int = 5                  # reference srand(5), NB_LDPC.c:89
    channel: ChannelSpec = ChannelSpec()
    decoder: DecoderConfig = DecoderConfig()
    encode: str = "device"         # "device" (bit-matmul) | "zero" (all-zero
    #                                codeword; valid for symmetric channels)
    fake_bch_t: int = 0            # a frame counts as erroneous only with
    #                                more than this many bit errors


@dataclasses.dataclass
class SimResult:
    frames: int
    frame_errors: int
    bit_errors: int
    undetected_errors: int
    iter_sum: int
    elapsed_s: float
    config: SimConfig
    code_name: str
    n: int = 0
    k: int = 0
    logq: int = 0
    decoder_steps: int = 0         # decoder steps (a batch's largest
    #                                iteration count), summed over batches

    @property
    def fer(self) -> float:
        return self.frame_errors / max(self.frames, 1)

    @property
    def ber(self) -> float:
        return self.bit_errors / max(self.frames * self.k * self.logq, 1)

    @property
    def fer_ci(self):
        return wilson_ci(self.frame_errors, max(self.frames, 1))

    @property
    def avg_iters(self) -> float:
        return self.iter_sum / max(self.frames, 1)

    @property
    def frames_per_s(self) -> float:
        return self.frames / max(self.elapsed_s, 1e-9)

    @property
    def info_mbps(self) -> float:
        return self.frames_per_s * self.k * self.logq / 1e6

    def to_dict(self) -> dict:
        return dict(
            code=self.code_name, ebn0_db=self.config.ebn0_db,
            frames=self.frames, frame_errors=self.frame_errors,
            bit_errors=self.bit_errors, undetected=self.undetected_errors,
            fer=self.fer, ber=self.ber, fer_ci=list(self.fer_ci),
            avg_iters=self.avg_iters, frames_per_s=self.frames_per_s,
            info_mbps=self.info_mbps, elapsed_s=self.elapsed_s,
            decoder_steps=self.decoder_steps,
            schedule=self.config.decoder.schedule, cn=self.config.decoder.cn,
            cn_impl=self.config.decoder.cn_impl,
            nm=self.config.decoder.nm, offset=self.config.decoder.offset,
            max_iters=self.config.decoder.max_iters,
            config_key=config_key(self.config),
        )


def config_key(cfg: SimConfig) -> str:
    """Signature of everything that shapes a point's result (batch size and
    max_frames excluded; the stop rule included, since it biases FER).
    The port has no lowering knobs, so no environment enters the key."""
    d, ch = cfg.decoder, cfg.channel
    chan = (f"{ch.kind}:{ch.sigma_convention}:rot{int(ch.rotated)}"
            f":ray{int(ch.rayleigh)}:ssd{int(ch.ssd)}"
            f":er{ch.erasure_prob:g}:{ch.labeling}")
    dec = (f"{d.schedule}:{d.cn}:{d.cn_impl}:nm{d.nm}:off{d.offset:g}"
           f":op{d.nboper}:it{d.max_iters}:{d.storage}:{d.dtype}")
    if d.cn == "syndrome":
        dec += (f":syn{d.syn_ncv},{d.syn_d},{d.syn_shape},"
                f"{d.syn_max_configs},{int(d.syn_bayes)},"
                f"{int(d.syn_presort)},{d.syn_sat}")
    return (f"{chan}|{dec}|stop{cfg.stop_errors}|bch{cfg.fake_bch_t}"
            f"|enc:{cfg.encode}|col{COLORING_VERSION}")


def _popcount(x: torch.Tensor) -> torch.Tensor:
    # popcount for small ints (logq <= 8 bits)
    c = torch.zeros_like(x)
    for b in range(8):
        c = c + ((x >> b) & 1)
    return c


def batch_generators(seed: int, batch_idx: int, device,
                     shard: Optional[int] = None):
    """(info-bit generator, channel generator) of one batch: from
    ``SeedSequence([seed, batch_idx])``, or for shard ``r`` of a sharded
    run (``parallel/mesh``) from ``SeedSequence([seed, batch_idx, r])``."""
    entropy = [seed, batch_idx] + ([] if shard is None else [shard])
    states = np.random.SeedSequence(entropy).generate_state(2, np.uint64)
    gens = []
    for s in states:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(s))
        gens.append(gen)
    return tuple(gens)


def make_codeword_fn(code: NBCode, cfg: SimConfig,
                     enc: Optional[Encoder] = None):
    """Returns (make_codeword(gen, pmat) -> [F, N] int64 symbols, encode_bits
    (info_bits, pmat) -> [F, N], encoder, pmat as a NumPy uint8 array).

    The device encoder is one product ``info_bits @ P`` with P the binary
    generator, then mod 2.  Parity sums reach k*logq (16,200 at N = 8100,
    GF(256)), which bf16 cannot hold, so the product is float32 with TF32
    off: exact, since every operand is 0 or 1 and every sum is an integer
    below 2^24.  This function sets
    ``torch.backends.cuda.matmul.allow_tf32 = False`` for that reason.
    """
    f = cfg.frames_per_batch
    n, m, k, logq = code.n, code.m_rows, code.k, code.logq
    if cfg.encode == "zero":
        def make_codeword(gen, pmat):
            return torch.zeros((f, n), dtype=torch.int64, device=pmat.device)

        return make_codeword, None, enc, np.zeros((1, 1), np.uint8)
    if cfg.encode != "device":
        raise ValueError(cfg.encode)
    torch.backends.cuda.matmul.allow_tf32 = False
    if enc is None:
        enc = gaussian_elimination(code)
    pmat_np = np.asarray(enc.bit_generator, np.uint8)
    perm = torch.as_tensor(np.asarray(enc.perm, np.int64))
    perms = {}      # device -> perm there: a copy from host memory waits
    #                 for the device, so it is made once, not per batch

    def encode_bits(info_bits, pmat):
        """info_bits: [F, k*logq] 0/1 (any dtype) -> codeword [F, N]."""
        dev = pmat.device
        if dev not in perms:
            perms[dev] = perm.to(dev)
        fb = info_bits.shape[0]
        bits = info_bits.to(device=dev, dtype=torch.float32)
        par_bits = torch.matmul(bits, pmat).to(torch.int64) & 1
        shifts = torch.arange(logq, device=dev)
        par_syms = (par_bits.reshape(fb, m, logq) << shifts).sum(-1)
        info_syms = (bits.to(torch.int64).reshape(fb, k, logq) << shifts).sum(-1)
        p = perms[dev]
        cw = torch.zeros((fb, n), dtype=torch.int64, device=dev)
        cw[:, p[:m]] = par_syms
        cw[:, p[m:]] = info_syms
        return cw

    def make_codeword(gen, pmat):
        info_bits = torch.randint(0, 2, (f, k * logq), generator=gen,
                                  device=pmat.device, dtype=torch.float32)
        return encode_bits(info_bits, pmat)

    return make_codeword, encode_bits, enc, pmat_np


class MonteCarlo:
    """Host-side accumulation loop with early stopping over the batch step:
    ``gen`` (codewords + channel), ``decode``, ``count``.  Every batch
    decodes under one device-loop key, so one capture serves every batch
    and every Eb/N0 point of a sweep (``decoder/device_loop``)."""

    def __init__(self, code: NBCode, cfg: SimConfig,
                 enc: Optional[Encoder] = None, *, device,
                 shard: Optional[int] = None):
        """``device`` is required: a run names the device it measures, and
        a missing card is an error, never a silent fall back to the CPU.
        ``shard``: this process's rank in a sharded run, whose batches draw
        the shard's own streams (``batch_generators``)."""
        self.code = code
        self.cfg = cfg
        self.device = torch.device(device)
        self.shard = shard
        self.graph = DeviceGraph.from_code(code)
        self._make_codeword, self.encode_bits, self.enc, pmat_np = (
            make_codeword_fn(code, cfg, enc))
        # upload as uint8, widen on the device
        self._pmat = torch.from_numpy(pmat_np).to(self.device).to(torch.float32)

    def gen(self, batch_idx: int):
        """(codewords [F, N] int64, intrinsic [F, N, q] f32) of one batch.
        Spans ``nbldpc.seed``, ``nbldpc.encode`` and ``nbldpc.channel`` in
        ``nbldpc.gen``; markers ``encode``, ``channel`` and ``end``
        (``device_loop.mark``) at their device boundaries."""
        with span("gen"):
            with span("seed"):
                kinfo, kchan = batch_generators(self.cfg.seed, batch_idx,
                                                self.device, self.shard)
            with span("encode"):
                mark("encode", self.device)
                cw = self._make_codeword(kinfo, self._pmat)
            with span("channel"):
                mark("channel", self.device)
                code = self.code
                intr = simulate(kchan, cw, code.q, self.cfg.channel,
                                self.cfg.ebn0_db, code.rate)
            mark("end", self.device)
        return cw, intr

    def count(self, decide, cw, iters, conv):
        """[frames, frame_errors, bit_errors, undetected, iter_sum,
        decoder steps] as int64, and the per-frame error flags."""
        with span("count"):
            k = self.code.k
            diff = decide[:, :k] ^ cw[:, :k]
            bit_err = _popcount(diff).sum(dim=1)
            frame_err = bit_err > self.cfg.fake_bch_t
            counters = torch.stack([
                torch.full((), decide.shape[0], dtype=torch.int64,
                           device=decide.device),
                frame_err.sum(), bit_err.sum(), (frame_err & conv).sum(),
                iters.sum().to(torch.int64), iters.max().to(torch.int64),
            ])
        return counters, frame_err

    def step(self, batch_idx: int):
        """``gen`` -> ``decode`` -> ``count`` of one batch, in the span
        ``nbldpc.step`` whose argument is the batch index."""
        with span("step", str(batch_idx)):
            cw, intr = self.gen(batch_idx)
            decide, iters, conv = decode(self.graph, intr, self.cfg.decoder)
            return self.count(decide, cw, iters, conv)

    def run(self, verbose: bool = False) -> SimResult:
        cfg = self.cfg
        totals = np.zeros(6, dtype=np.int64)
        t0 = time.perf_counter()
        batch_idx = 0
        while totals[0] < cfg.max_frames and totals[1] < cfg.stop_errors:
            counters, _ = self.step(batch_idx)
            totals += counters.cpu().numpy()
            batch_idx += 1
            if verbose:
                fer = totals[1] / max(totals[0], 1)
                print(
                    f"\r<{totals[3]}> FER= {totals[1]} / {totals[0]} "
                    f"= {fer:.3g} avg_it={totals[4]/max(totals[0],1):.2f}",
                    end="", flush=True,
                )
        elapsed = time.perf_counter() - t0
        if verbose:
            print()
        return SimResult(
            frames=int(totals[0]), frame_errors=int(totals[1]),
            bit_errors=int(totals[2]), undetected_errors=int(totals[3]),
            iter_sum=int(totals[4]), elapsed_s=elapsed, config=cfg,
            code_name=self.code.name, n=self.code.n, k=self.code.k,
            logq=self.code.logq, decoder_steps=int(totals[5]),
        )
