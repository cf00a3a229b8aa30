"""A batch's random draws and its BPSK / AWGN intrinsic costs.

The Monte-Carlo loop draws batch ``b`` of shard ``r`` from two
``torch.Generator``s on the card, seeded with the two 64-bit words of
``numpy.random.SeedSequence([seed, b])`` (``[seed, b, r]`` in a sharded
run): the information bits from the first (``randint(0, 2)`` as float32,
``[F, k * logq]``), the channel noise from the second (``randn``,
``[F, N, logq]``).  The same calls on the same card give the same draws.

The intrinsic cost of symbol g is ``sum_b (y_b - (1 - 2 g_b))^2 / (2
sigma^2)`` less its minimum over g, which is ``(2 / sigma^2) sum_b g_b y_b``
less its minimum: one float32 product with TF32 off.  ``sigma`` follows
from Eb/N0 and the code rate: ``sqrt(1 / (2 R 10^(Eb/N0 / 10)))``.
"""
from __future__ import annotations

import numpy as np
import torch


def generators(seed: int, batch: int, device, shard=None):
    """(information-bit generator, noise generator) of one batch."""
    entropy = [seed, batch] + ([] if shard is None else [shard])
    words = np.random.SeedSequence(entropy).generate_state(2, np.uint64)
    gens = []
    for w in words:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(w))
        gens.append(gen)
    return gens


def info_bits(gen, frames: int, k: int, logq: int, device) -> torch.Tensor:
    return torch.randint(0, 2, (frames, k * logq), generator=gen,
                         device=device, dtype=torch.float32)


def sigma(ebn0_db: float, rate: float) -> float:
    return float(np.sqrt(1.0 / (2.0 * rate * 10.0 ** (float(ebn0_db) / 10))))


def received(gen, cw: torch.Tensor, q: int, sig: float) -> torch.Tensor:
    """[F, N, logq] channel outputs of codeword ``cw`` [F, N]."""
    logq = q.bit_length() - 1
    bits = ((cw[..., None] >> torch.arange(logq, device=cw.device)) & 1)
    tx = 1.0 - 2.0 * bits.to(torch.float32)
    noise = torch.randn(tx.shape, generator=gen, device=cw.device,
                        dtype=torch.float32)
    return tx + sig * noise


def intrinsic(y: torch.Tensor, q: int, sig: float,
              tf32: bool = False) -> torch.Tensor:
    """[F, N, q] float32 min-normalised costs of the outputs ``y``.
    ``tf32``: round ``y`` to TF32's 10-bit mantissa first, as a TF32
    product reads it (the control)."""
    logq = q.bit_length() - 1
    g = torch.arange(q, device=y.device)
    bmat = ((g[:, None] >> torch.arange(logq, device=y.device)) & 1)
    if tf32:
        y = round_tf32(y)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lin = (2.0 / (sig * sig)) * torch.matmul(y, bmat.T.to(torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return lin - lin.min(dim=-1, keepdim=True).values


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits;
    ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
