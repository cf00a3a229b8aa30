"""BPSK/AWGN channel and its matmul demapper, on torch tensors.

Port of the BPSK part of ``ems_nbldpc_tpu/models/channels.py``:

* sigma convention ``sigma = sqrt(1 / (2 * rate * 10^(EbN0/10)))``
  (reference ``channel.c:51``);
* per-symbol intrinsic cost ``sum_bits (y_b - bpsk(bit_b(g)))^2 /
  (2 sigma^2)`` (``channel.c:66-76``), expanded to the affine form
  ``C + (2/sigma^2) * sum_b y_b * bit_b(g)`` — one matrix product against
  the ``[q, m]`` bit table; the constant cancels under min-normalization.

Randomness comes from an explicit ``torch.Generator``.  The QAM/APSK/4-D
channels are not ported yet; ``simulate`` raises for them.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..gf import get_gf


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """What to simulate between encoder and decoder (same fields as the
    JAX package's ``ChannelSpec``; only ``kind="bpsk"`` is ported)."""
    kind: str = "bpsk"            # bpsk | qam | apsk64 | qam256_4d
    sigma_convention: str = "ebn0"  # ebn0 (channel.c:51) | snr (channel.c:598)
    rotated: bool = False
    rayleigh: bool = False
    ssd: bool = False
    erasure_prob: float = 0.0
    labeling: str = "ref"


def sigma_for(spec: ChannelSpec, ebn0_db: float, rate: float) -> float:
    """Noise sigma for a python-float Eb/N0 (dB)."""
    snr_lin = 10.0 ** (float(ebn0_db) / 10.0)
    if spec.sigma_convention == "ebn0":
        return float(np.sqrt(1.0 / (2.0 * rate * snr_lin)))
    return float(np.sqrt(1.0 / (2.0 * snr_lin)))


@functools.lru_cache(maxsize=None)
def bit_matrix(q: int) -> np.ndarray:
    """[q, m] float: bit image (LSB-first) of each poly-rep symbol."""
    return get_gf(q).bits(np.arange(q)).astype(np.float32)


def bpsk_awgn(gen: torch.Generator, cw: torch.Tensor, q: int, sigma: float):
    """BPSK-modulate + AWGN; return (intrinsic_cost [F,N,q], y [F,N,m]).

    cw: [F, N] integer poly-rep codeword symbols; the noise is drawn from
    ``gen`` on ``cw``'s device.
    """
    m = q.bit_length() - 1
    shifts = torch.arange(m, device=cw.device)
    bits = ((cw[..., None] >> shifts) & 1).to(torch.float32)     # [F,N,m]
    tx = 1.0 - 2.0 * bits
    noise = torch.randn(tx.shape, generator=gen, device=cw.device,
                        dtype=torch.float32)
    y = tx + sigma * noise
    return intrinsic_from_bpsk(y, q, sigma), y


def intrinsic_from_bpsk(y: torch.Tensor, q: int, sigma: float) -> torch.Tensor:
    """cost[.., g] = sum_b (y_b - (1-2 g_b))^2 / (2 sigma^2), min-normalized.

    Expanded: cost[g] = C + (2/sigma^2) * sum_b g_b * y_b — one f32 matmul.
    It runs in full f32 only while ``torch.backends.cuda.matmul.allow_tf32``
    is False (PyTorch's default, set explicitly by ``sim/mc``).
    """
    bmat = torch.as_tensor(bit_matrix(q), device=y.device)        # [q, m]
    lin = (2.0 / (sigma * sigma)) * torch.matmul(y, bmat.T)
    return lin - lin.min(dim=-1, keepdim=True).values


def simulate(gen: torch.Generator, cw: torch.Tensor, q: int,
             spec: ChannelSpec, ebn0_db: float, rate: float) -> torch.Tensor:
    """Dispatch to the channel model; returns intrinsic cost [F,N,q]."""
    sigma = sigma_for(spec, ebn0_db, rate)
    if spec.kind == "bpsk":
        cost, _ = bpsk_awgn(gen, cw, q, sigma)
        return cost
    if spec.kind in ("qam", "apsk64", "qam256_4d"):
        raise NotImplementedError(
            f"channel kind={spec.kind!r} is not ported yet "
            "(ROADMAP Queue 1: remaining channels)"
        )
    raise ValueError(spec.kind)
