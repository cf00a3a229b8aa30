"""The comparison that decides a run's ``correct``.

After the window, with the program's state freed, the reference works out
again, for each batch the run kept (a sample drawn from the seed, with the
batch of the most decoder steps in it), what the timed path had to give:

* ``codewords_wrong``: frames whose codeword fails a check of H or does
  not carry the frame's information bits (drawn again from the seed) on
  the encoder's information set;
* ``intrinsic_rel_err``: the widest gap between the program's intrinsic
  costs and the reference's (the same noise, drawn again), over the
  reference's largest cost, on the kept frames;
* ``decode_differ_pct``: the share of the kept batches' frames whose
  decisions, iteration count or convergence flag differ from the
  reference decoder's on the reference's intrinsic costs;
* ``counters_wrong``: kept batches whose counters (frames, frame errors,
  bit errors, undetected errors, iterations, decoder steps) differ from
  those the reference counts from the program's decisions against the
  codewords;
* ``batch_frames_wrong``: window batches whose frame counter is not the
  configured F times the ranks;
* ``exchange_wrong`` (sharded runs): batches whose all-reduced counters
  are not the ranks' own summed (the decoder steps: their largest).

Each number has its limit in the configuration's ``check``.

``compare(..., control=True)`` puts the control in the program's place: the
reference computed one precision step below the configuration's (its
intrinsic costs from a TF32 product, its family's control decode) gives the
kept frames' costs and the decoded frames' decisions, iteration counts and
flags, and those go through the same comparison, ``finish`` and
``verdict`` as a run's outputs.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from .reference import channel, code as ref_code, encoder

def reference_family(name: str):
    return importlib.import_module(f"simbench.reference.{name}")


class Reference:
    """The reference's code graph, information set and decoder of a
    configuration."""

    def __init__(self, config: dict, rows, coefs):
        c = config["code"]
        self.config = config
        self.code = ref_code.build(rows, coefs, c["n"], c["q"])
        self.perm = encoder.information_set(self.code)
        self.family = reference_family(config["reference"])

    def batch(self, seed: int, b: int, device, shard=None):
        """(information symbols [F, k], noise generator) of batch ``b``."""
        code, f = self.code, self.config["frames_per_batch"]
        logq = code.q.bit_length() - 1
        g_info, g_chan = channel.generators(seed, b, device, shard)
        bits = channel.info_bits(g_info, f, code.k, logq, device)
        return encoder.info_symbols(bits, code.k, logq), g_chan

    def received(self, g_chan, cw, ebn0_db: float):
        """[F, N, logq] channel outputs of codewords ``cw`` (all F frames:
        the noise is drawn for the whole batch)."""
        code = self.code
        sig = channel.sigma(ebn0_db, code.k / code.n)
        return channel.received(g_chan, cw, code.q, sig), sig

    def intrinsic(self, y, sig: float, rows, control=False):
        """[len(rows), N, q] intrinsic costs of frames ``rows`` of the
        outputs ``y``."""
        return channel.intrinsic(y.index_select(0, rows), self.code.q, sig,
                                 tf32=control)

    def decode(self, intr, control=False):
        return self.family.decode(self.code, intr, self.config["decoder"],
                                  control=control)


def in_range(x: torch.Tensor, q: int) -> bool:
    return x.numel() == 0 or (int(x.min()) >= 0 and int(x.max()) < q)


def count(code, decide, cw, iters, conv) -> np.ndarray:
    """The counters of one batch: frames, frame errors (any bit error in
    the first k symbols), bit errors there, undetected errors (frame
    errors among converged frames), iterations, decoder steps."""
    diff = (decide[:, :code.k] ^ cw[:, :code.k]).to(torch.int64)
    bits = torch.zeros_like(diff)
    for b in range(code.q.bit_length() - 1):
        bits += (diff >> b) & 1
    bit_err = bits.sum(dim=1)
    frame_err = bit_err > 0
    return np.array([decide.shape[0], int(frame_err.sum()),
                     int(bit_err.sum()), int((frame_err & conv).sum()),
                     int(iters.to(torch.int64).sum()),
                     int(iters.max())], np.int64)


def decoded_frames(f: int, n: int, iters, seed: int, batch: int):
    """The frames of a kept batch that the reference decodes: all ``f``, or
    ``n`` drawn from the seed with the batch's longest (most iterations)
    among them."""
    if n >= f:
        return np.arange(f)
    rng = np.random.default_rng([seed, batch, 0xDEC0DE])
    pick = set(rng.choice(f, n - 1, replace=False).tolist())
    pick.add(int(torch.argmax(iters.to(torch.int64))))
    while len(pick) < n:
        pick.add(int(rng.integers(0, f)))
    return np.array(sorted(pick))


def compare(ref: Reference, kept, seed: int, ebn0_db: float, frames_idx,
            shard=None, sample_seed=None, control=False) -> dict:
    """The numbers of the kept batches (raw sums, see ``finish``):
    ``seed`` is the batches' stream seed, ``sample_seed`` (default
    ``seed``) draws the frames the reference decodes.  ``control``: the
    control's outputs stand in for the program's (module docstring)."""
    sample_seed = seed if sample_seed is None else sample_seed
    code = ref.code
    f = ref.config["frames_per_batch"]
    n_dec = int(ref.config.get("reference_frames", f))
    out = dict(codewords_wrong=0, intr_err=0.0, intr_scale=0.0,
               frames=0, differ=0, counters_wrong=0)
    for k in kept:
        dev = k.cw.device
        info, g_chan = ref.batch(seed, k.batch, dev, shard)
        cw, decide = k.cw.to(torch.int64), k.decide.to(torch.int64)
        shape_ok = (tuple(cw.shape) == (f, code.n)
                    and tuple(decide.shape) == (f, code.n)
                    and k.iters.shape[0] == f and k.conv.shape[0] == f)
        if not (shape_ok and in_range(cw, code.q)
                and in_range(decide, code.q)):
            out["codewords_wrong"] += f
            out["counters_wrong"] += 1
            out["differ"] += f
            out["frames"] += f
            continue
        wrong = encoder.wrong_codewords(code, ref.perm, cw, info)
        out["codewords_wrong"] += int(wrong.sum())
        # the reference's codeword is the one codeword that carries the
        # frame's information symbols; where the program's is it, it is used
        y, sig = ref.received(g_chan, cw, ebn0_db)
        kept_rows = torch.as_tensor(frames_idx, device=dev)
        want = ref.intrinsic(y, sig, kept_rows)
        got = (ref.intrinsic(y, sig, kept_rows, control=True) if control
               else k.intr.float())
        out["intr_err"] = max(out["intr_err"],
                              float((got - want).abs().max()))
        out["intr_scale"] = max(out["intr_scale"], float(want.abs().max()))
        sel = torch.as_tensor(decoded_frames(f, n_dec, k.iters, sample_seed,
                                             k.batch), device=dev)
        intr = ref.intrinsic(y, sig, sel)
        del y
        d, it, cv = ref.decode(intr)
        iters, conv, local = k.iters, k.conv, k.local
        if control:
            # the control decodes the same frames; its counters are the
            # reference's own count of its decisions
            dc, itc, cvc = ref.decode(intr, control=True)
            decide, iters, conv = decide.clone(), iters.clone(), conv.clone()
            decide[sel], iters[sel], conv[sel] = (
                dc, itc.to(iters.dtype), cvc.to(conv.dtype))
            local = torch.as_tensor(count(code, decide, cw, iters, conv))
        del intr
        differ = ((d != decide[sel]).any(dim=1)
                  | (it != iters[sel].to(it.dtype)) | (cv != conv[sel]))
        out["differ"] += int(differ.sum())
        out["frames"] += len(sel)
        if not np.array_equal(count(code, decide, cw, iters, conv),
                              local.cpu().numpy()):
            out["counters_wrong"] += 1
    return out


def finish(raw: dict, counters: np.ndarray, frames_per_batch: int) -> dict:
    """The compared numbers from the raw sums and every window batch's
    (global) counters."""
    return dict(
        codewords_wrong=raw["codewords_wrong"],
        intrinsic_rel_err=(raw["intr_err"] / raw["intr_scale"]
                           if raw["intr_scale"] > 0 else float("inf")),
        decode_differ_pct=100.0 * raw["differ"] / max(raw["frames"], 1),
        counters_wrong=raw["counters_wrong"],
        batch_frames_wrong=int((counters[:, 0] != frames_per_batch).sum()))


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: [number, limit]})."""
    shown = {k: [numbers[k], limits[k]] for k in numbers}
    ok = all(np.isfinite(v) and v <= lim for v, lim in shown.values())
    return bool(ok), shown
