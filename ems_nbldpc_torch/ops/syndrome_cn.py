"""Syndrome-based EMS check node, in plain torch.

Port of ``ems_nbldpc_tpu/ops/syndrome_cn.py`` (the reference's syndrome
architecture, ``syndrome_decoder.c:26-284``, with its config-table
machinery).  The host side is a NumPy copy of the JAX package's table
generators; the device side keeps the JAX version's sort-based form, so that
this module is the meaning of the op and matches JAX bit for bit:

1. inputs are the nm best (value, GF id) pairs of each edge, ascending,
   GF ids in the rotated domain;
2. optional presorting of the edges by their 2nd-best value (the first
   ``border`` re-sorted by their 3rd-best);
3. a static config table [C, dc] of deviation patterns (entry k: the k-th
   best entry of that edge);
4. each config's syndrome: the sum of the chosen values (f32, added in
   slot order) and the XOR of the chosen ids;
5. per edge, over the configs with no deviation on it: the bucket minimum
   by decorrelated GF id, with optional bayes combining of a bucket's two
   best, kept to the ``min(C, k + 1, q)`` best buckets and saturated above
   the k-th best config value.

Values are quantised to bf16 for the bucket and selection keys, as in the
JAX version, whose packed int32 keys sort plain ascending.  The hand-written
CUDA kernel of the same step is ``ops/cuda_syndrome.py``.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from .minconv import INF

# ---------------- host-side config tables ----------------


def gen_config_full(dc: int, d1: int, d2: int, d3: int) -> np.ndarray:
    """Full-product deviation patterns (gen_config_table :1588-1648)."""
    rows = [np.zeros(dc, np.int32)]
    for i in range(dc):
        for k in range(1, d1 + 1):
            r = np.zeros(dc, np.int32); r[i] = k; rows.append(r)
    for i, j in itertools.combinations(range(dc), 2):
        for a in range(1, d2 + 1):
            for b in range(1, d2 + 1):
                r = np.zeros(dc, np.int32); r[i] = a; r[j] = b; rows.append(r)
    for i, j, k in itertools.combinations(range(dc), 3):
        for a in range(1, d3 + 1):
            for b in range(1, d3 + 1):
                for c in range(1, d3 + 1):
                    r = np.zeros(dc, np.int32)
                    r[i], r[j], r[k] = a, b, c
                    rows.append(r)
    return np.stack(rows)


def gen_config_trapeze(dc: int, d1: int, d2: int, d3: int,
                       d4: int = 2) -> np.ndarray:
    """Trapeze-shaped patterns: deviation sums bounded (gen_config_table2
    :1661-1767); the reference bounds the 0-based loop indices, i.e. the
    sum of (deviation - 1) over a pattern's edges."""
    rows = [np.zeros(dc, np.int32)]
    for i in range(dc):
        for k in range(1, d1 + 1):
            r = np.zeros(dc, np.int32); r[i] = k; rows.append(r)
    for i, j in itertools.combinations(range(dc), 2):
        for a in range(d2):
            for b in range(d2):
                if a + b < d2:
                    r = np.zeros(dc, np.int32)
                    r[i], r[j] = a + 1, b + 1
                    rows.append(r)
    for i, j, k in itertools.combinations(range(dc), 3):
        for a in range(d3):
            for b in range(d3):
                for c in range(d3):
                    if a + b + c < d3:
                        r = np.zeros(dc, np.int32)
                        r[i], r[j], r[k] = a + 1, b + 1, c + 1
                        rows.append(r)
    if dc >= 4 and d4 > 0:
        for o, i, j, k in itertools.combinations(range(dc), 4):
            for a in range(d4):
                for b in range(d4):
                    for c in range(d4):
                        for p in range(d4):
                            if a + b + c < d4:
                                r = np.zeros(dc, np.int32)
                                r[i], r[j], r[k], r[o] = (
                                    a + 1, b + 1, c + 1, p + 1)
                                rows.append(r)
    return np.stack(rows)


def gen_config_2dev(dc: int, d1: int) -> np.ndarray:
    """Single-deviation-only table (gen_config_table3 :1784-1822)."""
    rows = [np.zeros(dc, np.int32)]
    for i in range(dc):
        for k in range(1, d1 + 1):
            r = np.zeros(dc, np.int32); r[i] = k; rows.append(r)
    return np.stack(rows)


def gen_config_bordered(dc: int, d1: int, d2: int, d3: int = 0,
                        border: int = 6) -> np.ndarray:
    """Irregular *bordered* table (gen_config_table4 :1838-2109), for
    presorted edges: the first ``border`` (least reliable) edges get d1
    single deviations and trapeze-d2 pairs among themselves plus depth-1
    triples and quads, the middle tier (up to ``dc - 3``) d2 singles and
    depth-1 pairs with the border, the last 3 edges depth-1 singles."""
    del d3  # unused by the live reference code path
    border = min(border, dc)
    border0 = max(dc - 3, border)
    rows = [np.zeros(dc, np.int32)]
    for i in range(border):
        for j in range(1, d1 + 1):
            r = np.zeros(dc, np.int32); r[i] = j; rows.append(r)
    for i in range(border, border0):
        for j in range(1, d2 + 1):
            r = np.zeros(dc, np.int32); r[i] = j; rows.append(r)
    for i in range(border0, dc):
        r = np.zeros(dc, np.int32); r[i] = 1; rows.append(r)
    for i, j in itertools.combinations(range(border), 2):
        for a in range(d2):
            for b in range(d2):
                if a + b < d2:
                    r = np.zeros(dc, np.int32)
                    r[i], r[j] = a + 1, b + 1
                    rows.append(r)
    for i in range(border0 - 1, border - 1, -1):
        for j in range(border - 1, -1, -1):
            r = np.zeros(dc, np.int32); r[i] = 1; r[j] = 1; rows.append(r)
    for i in range(border, border0):
        r = np.zeros(dc, np.int32); r[0] = 2; r[i] = 1; rows.append(r)
    for i, j, k in itertools.combinations(range(border), 3):
        r = np.zeros(dc, np.int32); r[i] = r[j] = r[k] = 1; rows.append(r)
    for j, k in itertools.combinations(range(1, border), 2):
        r = np.zeros(dc, np.int32); r[0] = 2; r[j] = r[k] = 1; rows.append(r)
    for ll, i, j, k in itertools.combinations(range(border), 4):
        r = np.zeros(dc, np.int32)
        r[ll] = r[i] = r[j] = r[k] = 1
        rows.append(r)
    for i, j, k in itertools.combinations(range(1, border), 3):
        r = np.zeros(dc, np.int32)
        r[0] = 2; r[i] = r[j] = r[k] = 1
        rows.append(r)
    return np.stack(rows)


@functools.lru_cache(maxsize=None)
def build_config_table(dc: int, d1: int = 40, d2: int = 15, d3: int = 5,
                       shape: str = "trapeze",
                       max_configs: int = 1000) -> np.ndarray:
    """The reference main's recipe (NB_LDPC.c:191-200): a table of
    ``shape``, sorted by (deviation count, index sum), capped at
    ``max_configs`` rows (0: no cap).  [C, dc] int32."""
    if shape == "full":
        t = gen_config_full(dc, d1, d2, d3)
    elif shape == "trapeze":
        t = gen_config_trapeze(dc, d1, d2, d3)
    elif shape == "2dev":
        t = gen_config_2dev(dc, d1)
    elif shape == "bordered":
        t = gen_config_bordered(dc, d1, d2, d3)
    else:
        raise ValueError(shape)
    ndev = (t > 0).sum(axis=1)
    cost = t.sum(axis=1)
    order = np.lexsort((cost, ndev))
    t = t[order]
    if max_configs and t.shape[0] > max_configs:
        t = t[:max_configs]
    return np.ascontiguousarray(t)


def syndrome_tables(dc: int, nm: int, n_cv: int = 45, d1: int = 40,
                    d2: int = 15, d3: int = 5, shape: str = "trapeze",
                    max_configs: int = 1000, sat_rule: str = "kth"):
    """The static tables of one CN configuration, as ``syndrome_checknode``
    builds them: the config table [C, dc] int32 (deviations clipped to
    nm - 1) and, per presorted edge position t, the rank k of its
    saturation level among the configs with no deviation on t, [dc] int64
    (``min(n_cv - 1 + 3t, n_masked - 1)``, or ``n_masked // 2`` for
    ``sat_rule="median"``)."""
    if sat_rule not in ("kth", "median"):
        raise ValueError(f"sat_rule={sat_rule!r}")
    cfg = build_config_table(dc, min(d1, nm - 1), min(d2, nm - 1),
                             min(d3, nm - 1), shape, max_configs)
    n_masked = (cfg == 0).sum(axis=0)
    if sat_rule == "median":
        kth = n_masked // 2
    else:
        kth = np.minimum(n_cv - 1 + 3 * np.arange(dc), n_masked - 1)
    return cfg, kth.astype(np.int64)


# ---------------- device-side CN ----------------

_IMAX = 0x7FFFFFFF


def bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the bit pattern of its bf16 rounding (to nearest even), as
    int32 in [0, 0xFFFF]."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def bf16_value(bits: torch.Tensor) -> torch.Tensor:
    """The f32 value of bf16 bit patterns (the low 16 bits of ``bits``)."""
    return (bits & 0xFFFF).to(torch.int16).view(torch.bfloat16).float()


def bayes_combine(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """bayes() (:2142-2211): the smaller of two duplicate-GF config values,
    shrunk by a factor of their difference (an approximation of the
    box-plus correction); m1 alone where m2 is INF-like or not finite."""
    dif = m2 - m1
    factor = torch.where(
        dif < 0.1, 0.5, torch.where(
            dif < 0.2, 0.75, torch.where(
                dif < 1.0, 0.825, torch.where(dif < 2.0, 0.9375, 1.0))))
    factor = factor.to(m1.dtype)
    return torch.where(torch.isfinite(m2) & (m2 < INF / 2), m1 * factor, m1)


def presort_order(vals: torch.Tensor) -> torch.Tensor:
    """[..., dc, nm] -> [..., dc] edge order: ascending 2nd-best value
    (stable), then the first ``border = min(4, dc)`` re-sorted by their
    3rd-best (presorting_mvc)."""
    order1 = torch.argsort(vals[..., 1], dim=-1, stable=True)
    border = min(4, vals.shape[-2])
    v2 = torch.gather(vals[..., 2], -1, order1)
    head = order1[..., :border]
    sub = torch.argsort(v2[..., :border], dim=-1, stable=True)
    head2 = torch.gather(head, -1, sub)
    return torch.cat([head2, order1[..., border:]], dim=-1)


def syndrome_cn_table(vals: torch.Tensor, gfs: torch.Tensor, q: int,
                      cfg: np.ndarray, kth, offset: float = 0.3,
                      use_bayes: bool = True,
                      presort: bool = True) -> torch.Tensor:
    """``syndrome_checknode`` on given tables: ``cfg`` [C, dc] (host, or a
    tensor) and ``kth`` [dc] (the saturation rank per presorted edge
    position, ``syndrome_tables``).  vals / gfs: [..., dc, nm]; returns
    dense [..., dc, q] CN outputs in the rotated domain."""
    cfg = np.asarray(cfg.cpu() if torch.is_tensor(cfg) else cfg, np.int64)
    kth = [int(k) for k in (kth.tolist() if torch.is_tensor(kth) else kth)]
    dc = vals.shape[-2]
    c = cfg.shape[0]
    dev = vals.device
    gfs = gfs.to(torch.int32)
    if presort:
        order = presort_order(vals)                          # [..., dc]
        inv = torch.argsort(order, dim=-1)
        idx = order[..., None].expand(vals.shape)
        vals = torch.gather(vals, -2, idx)
        gfs = torch.gather(gfs, -2, idx)

    # config syndromes: value sums in slot order, GF id XORs
    llr_c = 0.0
    gf_c = torch.zeros(vals.shape[:-2] + (c,), dtype=torch.int32, device=dev)
    for j in range(dc):
        idx = torch.as_tensor(cfg[:, j], device=dev)
        llr_c = llr_c + vals[..., j, idx]
        gf_c = gf_c ^ gfs[..., j, idx]

    outs = []
    for t in range(dc):
        mask = torch.as_tensor(cfg[:, t] == 0, device=dev)
        k = kth[t]
        gf_ext = gf_c ^ gfs[..., t, 0:1]
        llr_m = torch.where(mask, llr_c, INF)
        # the packed keys of the JAX version: (GF, value) for the bucket
        # minima, value alone for the saturation level
        vbits = bf16_bits(torch.clamp(llr_m, max=INF))
        k1 = torch.where(mask, (gf_ext << 16) | vbits, _IMAX)
        k1 = torch.sort(k1, dim=-1).values
        sat_bits = torch.sort(torch.where(mask, vbits, _IMAX), dim=-1).values
        sat = bf16_value(sat_bits[..., k:k + 1])
        gfp = k1 >> 16                                      # imax -> 32767
        v1 = bf16_value(k1)
        first = torch.ones(gfp.shape[:-1] + (1,), dtype=torch.bool,
                           device=dev)
        firsts = torch.cat([first, gfp[..., 1:] != gfp[..., :-1]], dim=-1)
        if use_bayes:
            nxt_same = torch.cat([gfp[..., :-1] == gfp[..., 1:], ~first],
                                 dim=-1)
            v2 = torch.where(nxt_same,
                             torch.cat([v1[..., 1:], v1[..., :1]], dim=-1),
                             INF)
            comb = bayes_combine(v1, v2)
        else:
            comb = v1
        # keep the best min(C, k + 1, q) distinct-GF entries
        keep = min(c, k + 1, q)
        cbits = bf16_bits(torch.clamp(comb, max=INF))
        k2 = torch.where(firsts & (gfp < q), (cbits << 8) | gfp, _IMAX)
        k2 = torch.sort(k2, dim=-1).values[..., :keep]
        live = k2 != _IMAX
        kg = torch.where(live, k2 & 0xFF, q)               # dead: no symbol
        kv = bf16_value(k2 >> 8)
        # scatter-min of the kept entries (each GF at most once)
        out = torch.full(kg.shape[:-1] + (q + 1,), INF, dtype=vals.dtype,
                         device=dev)
        out = out.scatter_reduce_(-1, kg.long(), kv, reduce="amin")[..., :q]
        out = torch.where(out > sat, sat + offset, out)
        outs.append(out)
    mcv = torch.stack(outs, dim=-2)                         # [..., dc, q]
    if presort:
        mcv = torch.gather(mcv, -2, inv[..., None].expand(mcv.shape))
    return mcv


def syndrome_checknode(
    vals, gfs, q: int, n_cv: int = 45, offset: float = 0.3,
    d1: int = 40, d2: int = 15, d3: int = 5, shape: str = "trapeze",
    max_configs: int = 1000, use_bayes: bool = True, presort: bool = True,
    sat_rule: str = "kth",
):
    """vals: [..., dc, nm] ascending; gfs: [..., dc, nm] rotated GF ids.

    Returns dense [..., dc, q] CtoV messages in the rotated domain.  The
    JAX ``syndrome_checknode``'s parameters and defaults."""
    dc, nm = vals.shape[-2:]
    cfg, kth = syndrome_tables(dc, nm, n_cv, d1, d2, d3, shape, max_configs,
                               sat_rule)
    return syndrome_cn_table(vals, gfs, q, cfg, kth, offset, use_bayes,
                             presort)
