"""Channel models and their demappers, on torch tensors.

Port of ``ems_nbldpc_tpu/models/channels.py``:

* BPSK-AWGN with the Eb/N0 sigma convention
  ``sigma = sqrt(1 / (2 * rate * 10^(EbN0/10)))`` (reference
  ``channel.c:51``) and the per-symbol cost ``sum_bits (y_b -
  bpsk(bit_b(g)))^2 / (2 sigma^2)`` (``channel.c:66-76``), expanded to the
  affine form ``C + (2/sigma^2) * sum_b y_b * bit_b(g)``: one matrix
  product against the ``[q, m]`` bit table (the constant cancels under
  min-normalization);
* 2-D QAM / rotated QAM / 64-APSK with the SNR convention ``sigma =
  sqrt(1 / (2 * 10^(SNR/10)))`` (``channel.c:231,598``), optional Rayleigh
  fading (one fade a symbol), SSD fading (one a component) and component
  erasures (``channel.c:588-594,648-672``);
* the 256-QAM 4-D channel (two 16-QAM uses, ``channel.c:749-929``) with
  per-dimension fades and the reference's receiver-side erasures.

Each non-BPSK channel is a draw step (``channel_draws``: noise, then
fades, then erasures, from one ``torch.Generator``) and a deterministic
function of the draws (``modulate_2d`` / ``modulate_4d``, then the
demapper).  The demapper is the hand-written CUDA kernel of
``ops/cuda_demap`` on a CUDA tensor and its plain version
(``demap_2d_plain`` / ``demap_4d_plain``) on a CPU tensor.  Both multiply
by ``inv = float32(1 / (2 sigma^2))`` rather than divide, so that the CPU,
torch on the card and the kernel round alike.

The constellation tables are NumPy copies of the JAX package's.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..gf import get_gf

KINDS = ("bpsk", "qam", "apsk64", "qam256_4d")
U_MIN = 1e-12              # smallest fade uniform (JAX's minval)


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """What to simulate between encoder and decoder (the JAX package's
    ``ChannelSpec``)."""
    kind: str = "bpsk"            # bpsk | qam | apsk64 | qam256_4d
    sigma_convention: str = "ebn0"  # ebn0 (channel.c:51) | snr (channel.c:598)
    rotated: bool = False          # rotated QAM (channel.c:348-357)
    rayleigh: bool = False         # Rayleigh fading per 2-D symbol
    ssd: bool = False              # per-component fading (SSD)
    erasure_prob: float = 0.0      # component erasures (channel.c:592-594)
    labeling: str = "ref"          # "ref": the reference's symbol->point
    #                                maps; "gray": the synthetic Gray maps;
    #                                "v2" (QAM): the v2 program's raster


def check_spec(spec: ChannelSpec, q: int) -> None:
    """Raise ``ValueError`` for a channel the tables cannot serve: JAX
    would assert or index a wrong-sized table."""
    if spec.kind not in KINDS:
        raise ValueError(f"channel kind {spec.kind!r}; one of {KINDS}")
    if spec.sigma_convention not in ("ebn0", "snr"):
        raise ValueError(f"sigma_convention {spec.sigma_convention!r}; "
                         "ebn0 or snr")
    if spec.kind == "bpsk":
        return
    if spec.kind == "qam256_4d" and q != 256:
        raise ValueError(f"qam256_4d needs q = 256, got {q}")
    if not 0.0 <= spec.erasure_prob < 1.0:
        raise ValueError(f"erasure_prob {spec.erasure_prob} not in [0, 1)")
    table_for(spec, q)  # raises for a q or labeling its table cannot serve


def sigma_for(spec: ChannelSpec, ebn0_db: float, rate: float) -> float:
    """Noise sigma for a python-float Eb/N0 (or SNR) in dB."""
    snr_lin = 10.0 ** (float(ebn0_db) / 10.0)
    if spec.sigma_convention == "ebn0":
        return float(np.sqrt(1.0 / (2.0 * rate * snr_lin)))
    return float(np.sqrt(1.0 / (2.0 * snr_lin)))


def inv_two_sigma2(sigma: float) -> float:
    """float32(1 / (2 sigma^2)), the factor every demapper multiplies by."""
    return float(np.float32(1.0 / (2.0 * sigma * sigma)))


@functools.lru_cache(maxsize=None)
def bit_matrix(q: int) -> np.ndarray:
    """[q, m] float: bit image (LSB-first) of each poly-rep symbol."""
    return get_gf(q).bits(np.arange(q)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bit_table(q: int, device: torch.device) -> torch.Tensor:
    """``bit_matrix(q)`` on ``device``, uploaded once: a copy from host
    memory waits for the device, which a per-batch upload would do."""
    return torch.as_tensor(bit_matrix(q), device=device)


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
    bmat = _bit_table(q, y.device)                                # [q, m]
    lin = (2.0 / (sigma * sigma)) * torch.matmul(y, bmat.T)
    return lin - lin.min(dim=-1, keepdim=True).values


# ---------------- constellations (NumPy copies of the JAX tables) --------

def _gray(n: int) -> np.ndarray:
    a = np.arange(n)
    return a ^ (a >> 1)


def _ref_qam_pam(labels: np.ndarray, mag_bits: int) -> np.ndarray:
    """One PAM coordinate of the reference's square-QAM labeling
    (channel.h ``table_16/64/256QAM``): bit 0 of ``labels`` is the sign;
    the magnitude nests outward from the highest magnitude bit,
    ``mag = 2^k + (1-2 b_1)(2^(k-1) + (1-2 b_2)(... (2 + (1-2 b_k))))``,
    giving the magnitude sequences [3,1], [7,1,5,3], [15,1,9,7,13,3,11,5].
    """
    v = np.ones_like(labels, dtype=np.float64)
    for j in range(mag_bits, 0, -1):          # innermost = highest bit
        b = (labels >> j) & 1
        v = (1 << (mag_bits - j + 1)) + (1 - 2 * b) * v
    sign = 1 - 2 * (labels & 1)
    return sign * v


# DVB-S2X 8+16+20+20 64-APSK labeling (reference ``table_64APSK``,
# channel.c:130-198): per binary label, a ring code into radii
# (1.0, 2.2, 3.6, 5.2) and an angle in units of pi/80.
_APSK64_RING = np.array([
    1, 1, 1, 1, 3, 3, 3, 3, 1, 1, 1, 1, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
    0, 0, 0, 0, 3, 3, 3, 3, 1, 1, 1, 1, 2, 2, 2, 2,
    0, 0, 0, 0, 3, 3, 3, 3, 1, 1, 1, 1, 2, 2, 2, 2])
_APSK64_ANG80 = np.array([
    125, 115, 35, 45, 140, 100, 20, 60, 135, 105, 25, 55,
    140, 100, 20, 60, 124, 116, 36, 44, 132, 108, 28, 52,
    124, 116, 36, 44, 132, 108, 28, 52, 130, 110, 30, 50,
    148, 92, 12, 68, 145, 95, 15, 65, 148, 92, 12, 68,
    150, 90, 10, 70, 156, 84, 4, 76, 155, 85, 5, 75,
    156, 84, 4, 76])


@functools.lru_cache(maxsize=None)
def constellation(kind: str, q: int, rotated: bool = False,
                  labeling: str = "ref") -> np.ndarray:
    """[q, 2] unit-average-power constellation points.

    The transmitted point of symbol g is row g (the symbol's binary image
    indexes the reference's tables, ``channel.c:630-636``).  QAM:
    ``labeling="ref"`` follows channel.h's tables (even bits to I, odd
    bits to Q, sign-refinement PAM), ``"gray"`` the synthetic Gray map
    (low bits to I), ``"v2"`` the v2 program's natural raster (I the high
    half of the bits).  64-APSK: ``"ref"`` the DVB-S2X table, ``"gray"``
    rings filled in label order.  ``rotated`` turns the points by 31.7°
    (``channel.c:348-357``).
    """
    g = np.arange(q)
    if kind == "qam":
        side = int(round(np.sqrt(q)))
        if side * side != q:
            raise ValueError(f"QAM needs a square q, got {q}")
        if labeling == "v2":
            hi, lo = g // side, g % side
            pts = np.stack([2.0 * hi - (side - 1),
                            2.0 * lo - (side - 1)], axis=1)
        elif labeling == "ref":
            m = q.bit_length() - 1
            xl = np.zeros(q, np.int64)
            yl = np.zeros(q, np.int64)
            for b in range(0, m, 2):
                xl |= ((g >> b) & 1) << (b // 2)
            for b in range(1, m, 2):
                yl |= ((g >> b) & 1) << (b // 2)
            mag_bits = m // 2 - 1
            pts = np.stack([_ref_qam_pam(xl, mag_bits),
                            _ref_qam_pam(yl, mag_bits)], axis=1)
        elif labeling == "gray":
            pam = 2 * np.arange(side) - (side - 1)
            gi = np.argsort(_gray(side))
            pts = np.zeros((q, 2))
            for s in range(q):
                pts[s] = (pam[gi[s % side]], pam[gi[s // side]])
        else:
            raise ValueError(f"qam labeling {labeling!r}")
    elif kind == "apsk64":
        if q != 64:
            raise ValueError(f"apsk64 needs q = 64, got {q}")
        radii = np.array([1.0, 2.2, 3.6, 5.2])
        if labeling == "ref":
            r = radii[_APSK64_RING]
            ang = np.pi * _APSK64_ANG80 / 80.0
            pts = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)
        elif labeling == "gray":
            counts = [8, 16, 20, 20]
            pts = []
            for c, r in zip(counts, radii):
                ang = 2 * np.pi * (np.arange(c) + 0.5) / c
                pts.extend([(r * np.cos(a), r * np.sin(a)) for a in ang])
            pts = np.array(pts)
        else:
            raise ValueError(f"apsk64 labeling {labeling!r}")
    else:
        raise ValueError(kind)
    if rotated:
        th = np.deg2rad(31.7)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        pts = pts @ rot.T
    # unit average power (channel.c:205-221)
    pts = pts / np.sqrt((pts ** 2).sum(axis=1).mean())
    return pts.astype(np.float32)


@functools.lru_cache(maxsize=None)
def constellation_4d(labeling: str = "ref",
                     rotated: bool = False) -> np.ndarray:
    """[256, 4] 4-D constellation (two 16-QAM uses), mean 2-D power 1.

    ``labeling="ref"``: the reference's ``table_256QAM_4D_16QAM_R``
    (channel.h:686-945), ``table[g] = (Q[(lo(g)+1) % 16], Q[hi(g)])`` with
    Q the {±1,±3}² grid in raster order turned by −31.7° (``rotated`` is
    not read).  ``"gray"``: two Gray 16-QAM uses, ``rotated`` honoured.
    """
    lo = np.arange(256) & 0xF
    hi = np.arange(256) >> 4
    if labeling == "ref":
        r = np.arange(16)
        grid = np.stack([2.0 * (r % 4) - 3.0, 2.0 * (r // 4) - 3.0], 1)
        th = np.deg2rad(-31.7)
        rot = np.array([[np.cos(th), -np.sin(th)],
                        [np.sin(th), np.cos(th)]])
        q16 = grid @ rot.T                                        # [16, 2]
        pts = np.concatenate([q16[(lo + 1) % 16], q16[hi]], axis=1)
    elif labeling == "gray":
        q16 = constellation("qam", 16, rotated, "gray")
        pts = np.concatenate([q16[lo], q16[hi]], axis=1)
    else:
        raise ValueError(f"qam256_4d labeling {labeling!r}")
    # norm_factor = sqrt(2*GF / sum |x|^2)  (channel.c:800-814)
    pts = pts / np.sqrt((pts ** 2).sum(axis=1).mean() / 2.0)
    return pts.astype(np.float32)


def table_for(spec: ChannelSpec, q: int) -> np.ndarray:
    """The [q, D] table of a non-BPSK channel (D = 2, or 4 for 4-D)."""
    if spec.kind == "qam256_4d":
        return constellation_4d(spec.labeling, spec.rotated)
    return constellation(spec.kind, q, spec.rotated, spec.labeling)


@functools.lru_cache(maxsize=None)
def _device_table(spec: ChannelSpec, q: int,
                  device: torch.device) -> torch.Tensor:
    """``table_for`` on ``device``, uploaded once."""
    return torch.as_tensor(table_for(spec, q), device=device)


# ---------------- draws, modulation, demappers ----------------

def channel_draws(gen: torch.Generator, shape, spec: ChannelSpec, dim: int):
    """The random numbers of one batch, in JAX's order (noise, fade,
    erasure) and shapes, on ``gen``'s device.

    shape: (F, N); dim: 2 or 4.  Returns ``(z, u, erased)``: z [F, N, dim]
    standard normal; u the fade uniforms clamped below at 1e-12 (``[F, N,
    dim]`` with ``ssd``; ``[F, N, 1]`` with ``rayleigh`` alone on the 2-D
    path, which the 4-D path does not read; else None); erased [F, N, dim]
    bool, ``rand < erasure_prob`` (None without erasures).
    """
    dev = gen.device
    full = (*shape, dim)
    z = torch.randn(full, generator=gen, device=dev, dtype=torch.float32)
    u = erased = None
    if spec.ssd or (spec.rayleigh and dim == 2):
        u = torch.rand(full if spec.ssd else (*shape, 1), generator=gen,
                       device=dev, dtype=torch.float32).clamp_(min=U_MIN)
    if spec.erasure_prob > 0.0:
        erased = torch.rand(full, generator=gen, device=dev,
                            dtype=torch.float32) < spec.erasure_prob
    return z, u, erased


def _fade(u, like):
    """att = sqrt(-log u), or ones without fading."""
    if u is None:
        return torch.ones_like(like)
    return torch.sqrt(-torch.log(u))


def _erase(att, erased, erasure_prob):
    """Erased components carry nothing; survivors are renormalised by
    1/sqrt(1-p) (``channel.c:652-669``), multiplied as an f32 factor."""
    if erased is None:
        return att
    scale = float(np.float32(1.0 / np.sqrt(1.0 - erasure_prob)))
    return torch.where(erased, 0.0, att * scale)


def modulate_2d(cw, pts, z, u, erased, sigma: float, erasure_prob: float):
    """(y, att), each [F, N, 2] contiguous f32: the 2-D transmitter, which
    sends AFTER the erasure renormalisation (``channel.c:648-675``)."""
    x = pts[cw]                                                   # [F,N,2]
    noise = sigma * z
    att = _erase(_fade(u, x), erased, erasure_prob)
    att = att.expand_as(x).contiguous()
    return att * x + noise, att


def modulate_4d(cw, cand, z, u, erased, sigma: float, erasure_prob: float):
    """(y, att), each [F, N, 4] contiguous f32: the 4-D transmitter keeps
    the reference's quirk (``channel.c:840`` vs ``:843-862``): the signal
    carries the raw fade, and only the receiver's att is erased and
    renormalised."""
    x = cand[cw]                                                  # [F,N,4]
    noise = sigma * z
    att = _fade(u, x)
    y = att * x + noise
    return y, _erase(att, erased, erasure_prob).contiguous()


def _col(t, d):
    return t[..., d:d + 1]


def demap_2d_plain(y, att, pts, inv: float) -> torch.Tensor:
    """cost[.., g] = (sum_d (y_d - a_d x_gd)^2) * inv, min-normalised: the
    JAX package's direct form, summed in the order d = 0, 1.  y, att:
    [..., 2]; pts: [q, 2] -> [..., q]."""
    cost = None
    for d in range(pts.shape[1]):
        diff = _col(y, d) - _col(att, d) * pts[:, d]
        sq = diff * diff
        cost = sq if cost is None else cost + sq
    cost = cost * inv
    return cost - cost.min(dim=-1, keepdim=True).values


def demap_4d_plain(y, att, cand, inv: float) -> torch.Tensor:
    """cost[.., g] = (sum_d a_d^2 x_gd^2 - 2 sum_d (a_d y_d) x_gd) * inv,
    min-normalised: the JAX package's expanded 4-D form (its two products
    against the table), each sum written out in the order d = 0..3.
    y, att: [..., 4]; cand: [q, 4] -> [..., q]."""
    ay, a2, c2 = att * y, att * att, cand * cand
    cross = pw = None
    for d in range(cand.shape[1]):
        c = _col(ay, d) * cand[:, d]
        p = _col(a2, d) * c2[:, d]
        cross = c if cross is None else cross + c
        pw = p if pw is None else pw + p
    cost = (pw - 2.0 * cross) * inv
    return cost - cost.min(dim=-1, keepdim=True).values


def channel_2d_from_draws(cw, pts, z, u, erased, sigma: float,
                          erasure_prob: float) -> torch.Tensor:
    """The 2-D channel's intrinsic cost [F, N, q] from its draws (K8 on a
    CUDA tensor, the plain demapper on a CPU one)."""
    from ..ops import cuda_demap

    y, att = modulate_2d(cw, pts, z, u, erased, sigma, erasure_prob)
    return cuda_demap.demap_2d(y, att, pts, inv_two_sigma2(sigma))


def qam256_4d_from_draws(cw, cand, z, u, erased, sigma: float,
                         erasure_prob: float) -> torch.Tensor:
    """The 4-D channel's intrinsic cost [F, N, 256] from its draws."""
    from ..ops import cuda_demap

    y, att = modulate_4d(cw, cand, z, u, erased, sigma, erasure_prob)
    return cuda_demap.demap_4d(y, att, cand, inv_two_sigma2(sigma))


def channel_2d(gen: torch.Generator, cw: torch.Tensor, q: int, sigma: float,
               spec: ChannelSpec) -> torch.Tensor:
    """QAM / rotated QAM / 64-APSK with optional Rayleigh or SSD fading and
    erasures (``ModelChannel``, channel.c:328-746, and
    ``ModelChannel_AWGN_64``, channel.c:112-312): intrinsic cost [F, N, q],
    min-normalised.  SSD wins over Rayleigh when both are set."""
    pts = _device_table(spec, q, cw.device)
    z, u, erased = channel_draws(gen, cw.shape, spec, 2)
    return channel_2d_from_draws(cw, pts, z, u, erased, sigma,
                                 spec.erasure_prob)


def qam256_4d(gen: torch.Generator, cw: torch.Tensor, sigma: float,
              spec: ChannelSpec) -> torch.Tensor:
    """GF(256) symbols over the 4-D (two 16-QAM uses) channel
    (``ModelChannel_AWGN_256QAM_4D``, channel.c:749-929): per-dimension
    fades when ``spec.ssd`` (the reference fades always), receiver-side
    erasures; ``rayleigh`` is not read."""
    cand = _device_table(spec, 256, cw.device)
    z, u, erased = channel_draws(gen, cw.shape, spec, 4)
    return qam256_4d_from_draws(cw, cand, z, u, erased, sigma,
                                spec.erasure_prob)


def simulate(gen: torch.Generator, cw: torch.Tensor, q: int,
             spec: ChannelSpec, ebn0_db: float, rate: float) -> torch.Tensor:
    """Dispatch to the channel model; returns intrinsic cost [F,N,q]."""
    check_spec(spec, q)
    sigma = sigma_for(spec, ebn0_db, rate)
    if spec.kind == "bpsk":
        cost, _ = bpsk_awgn(gen, cw, q, sigma)
        return cost
    if spec.kind == "qam256_4d":
        return qam256_4d(gen, cw, sigma, spec)
    return channel_2d(gen, cw, q, sigma, spec)
