"""K3's general step (``list_general_kernel`` in csrc/list_checknode.cu):
a NumPy model of its schedule, held against the JAX package's list merge
(``ems_nbldpc_tpu/ops/listcn.py``: ``list_combine``, ``fb_checknode_list``;
``ops/minconv.topk_message``) and the port's plain version
(``ems_nbldpc_torch/ops/listcn.py``), bit for bit.

The model follows the source:
* the exact merge at q = 256 and nm = q (``dense_pair``): each list a
  q-vector by GF id, each merge the XOR min-convolution of two, with lane
  l owning the outputs 8 l .. 8 l + 7 in the half order hl = l & 4, chunk
  c of one vector meeting chunk c ^ l of the other, minima on the f32
  bits as unsigned integers, clamped at BIG; only the dc outputs sorted; a
  row where a merge has fewer than q heads (GF ids below BIG: the tail) is
  flagged, and runs again through the list form;
* the exact selection (``select_exact_out``): 32-bit keys (a value's bits
  30..7 over its GF id) sorted, then odd-even transposition passes over
  the neighbours of one high part until none is out of its exact order;
* the exact list form's merge (``merge_exact_long``) at every other nm:
  the staircase {(i+1)(j+1) <= 2 nm}, a selection, the candidates past it
  whose sum is at most the nm-th's value, a selection again, the tail;
* the staircase (``select_stair_out``, ``merge_stair``): per-GF minima of
  bf16 bits over the staircase {(i+1)(j+1) <= nbOper}, the 256 keys
  (bits << 8 | GF id, an absent one the dup marker) sorted, the first nm.
Every comparison is exact.  The kernel itself runs only on the card
(``chip_smoke.py`` phase 3g)."""
import functools

import numpy as np
import pytest
import torch

from ems_nbldpc_torch.ops import listcn

Q = 256
BIG = np.float32(1e9)
BIG_BITS = int(BIG.view(np.uint32))
NONE = 0xFFFFFFFF
DUP = 0x7FFFFFFF
ROWS = 4                  # rows a case
DC = 4


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: under the tier-1 run's workers, torch's
    per-core threads on these small tensors cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(x):
    """The f32 bits of x as int64."""
    return np.asarray(x, np.float32).view(np.uint32).astype(np.int64)


# ---- dense_pair's index algebra at q = 256 ----
_L = np.arange(32)[:, None, None, None]       # lane
_T = np.arange(8)[None, :, None, None]        # output register
_C = np.arange(32)[None, None, :, None]       # chunk
_T2 = np.arange(8)[None, None, None, :]       # candidate register
_HL = _L & 4
_A_IDX = np.broadcast_to(8 * _C + _T2, (32, 8, 32, 8))
# chunk c ^ l of v, register R = t2 ^ T holding symbol 8 (c ^ l) + (R ^ hl)
_V_IDX = np.broadcast_to(8 * (_C ^ _L) + ((_T2 ^ _T) ^ _HL), (32, 8, 32, 8))
_S_IDX = (8 * _L + (_T ^ _HL))[:, :, 0, 0]    # register T's output


def dense_merge(u, v):
    """dense_pair on rows u, v [B, 256] f32: the clamped minima's f32 bits
    [B, 256] and the heads (GF ids below BIG) of each row."""
    s = (u[:, _A_IDX] + v[:, _V_IDX]).astype(np.float32)
    o = np.minimum(s.view(np.uint32).min(axis=(3, 4)), BIG_BITS)
    out = np.empty((u.shape[0], Q), np.uint32)
    out[:, _S_IDX] = o
    return out.view(np.float32), (out < BIG_BITS).sum(axis=1)


def test_dense_index_algebra_is_the_min_convolution():
    """Every output is held by one (lane, register), and its candidates
    are exactly the pairs (a, a ^ s): the schedule forms the whole XOR
    min-convolution."""
    assert sorted(_S_IDX.reshape(-1)) == list(range(Q))
    s = np.broadcast_to(_S_IDX[:, :, None, None], (32, 8, 32, 8))
    assert np.array_equal(_A_IDX ^ _V_IDX, s)
    for lane in range(32):
        for t in range(8):
            assert sorted(_A_IDX[lane, t].reshape(-1)) == list(range(Q))


def dense_of(v, g):
    """Lists [B, n] (f32 values, distinct GF ids) as q-vectors, BIG where
    absent."""
    d = np.full((v.shape[0], Q), BIG, np.float32)
    np.put_along_axis(d, g.astype(np.int64), v.astype(np.float32), axis=1)
    return d


def select_exact(vals, lim, n):
    """select_exact_out on one row: vals [256] value bits by GF id
    (int64), present where below lim; the n smallest (value bits, ids)
    ascending, and whether the 32-bit keys' order was kept (the first
    odd-even pass over neighbours of one high part moved nothing)."""
    ids = np.arange(Q)
    present = vals < lim
    k = np.sort(np.where(present,
                         (np.minimum(vals, 0x7FFFFFFF) >> 7) << 8 | ids, NONE))
    f = vals[k & 0xFF]
    passes = 0
    while True:
        passes += 1
        moved = False
        for start in (0, 1):                 # even pairs, then odd ones
            a = np.arange(start, Q - 1, 2)
            b = a + 1
            swap = (k[a] >> 8 == k[b] >> 8) & (
                (f[a] > f[b]) | ((f[a] == f[b]) & ((k[a] & 0xFF) >
                                                   (k[b] & 0xFF))))
            moved |= bool(swap.any())
            a, b = a[swap], b[swap]
            k[a], k[b] = k[b], k[a].copy()
            f[a], f[b] = f[b], f[a].copy()
        if not moved:
            break
    return f[:n], (k & 0xFF)[:n], passes == 1


def fwd(t, dc):
    return 0 if t == 0 else dc + t - 1


def bwd(t, dc):
    return dc - 1 if t == dc - 1 else 2 * dc - 3 + t


def out_src(k, dc):
    return bwd(1, dc) if k == 0 else fwd(dc - 2, dc) if k == dc - 1 else k


def dense_cn(lv, lg):
    """The dense form of the exact F/B check node on rows of dc >= 3 input
    lists lv, lg [B, dc, 256]: (ov, og [B, dc, 256] of the rows without a
    tail, tail [B])."""
    b, dc, nm = lv.shape
    assert nm == Q
    lists = {k: dense_of(lv[:, k], lg[:, k]) for k in range(dc)}
    tail = np.zeros(b, bool)

    def merge(x, y, o):
        lists[o], heads = dense_merge(lists[x], lists[y])
        tail[:] |= heads < nm

    chain(merge, dc)
    ov = np.full((b, dc, nm), np.nan, np.float32)
    og = np.full((b, dc, nm), -1, np.int64)
    for r in np.flatnonzero(~tail):
        for k in range(dc):
            v, g, _ = select_exact(bits(lists[out_src(k, dc)][r]), BIG_BITS,
                                   nm)
            ov[r, k] = v.astype(np.uint32).view(np.float32)
            og[r, k] = g
    return ov, og, tail


def chain(merge, dc):
    """The F/B chain's merges (x, y, o) in the kernel's order: the forward
    and backward steps, then the middles."""
    for u in range(1, dc - 1):
        merge(fwd(u - 1, dc), u, fwd(u, dc))
        v = dc - 1 - u
        merge(bwd(v + 1, dc), v, bwd(v, dc))
    for u in range(1, dc - 1):
        merge(fwd(u - 1, dc), bwd(u + 1, dc), u)


def list_cn(lv, lg):
    """The exact list form's F/B check node, row by row (merge_exact_long
    on each merge): (ov, og [B, dc, nm], tail [B]: a merge ran its tail)."""
    b, dc, nm = lv.shape
    ov = np.empty((b, dc, nm), np.float32)
    og = np.empty((b, dc, nm), np.int64)
    tail = np.zeros(b, bool)
    for r in range(b):
        lists = {k: (lv[r, k], lg[r, k]) for k in range(dc)}

        def merge(x, y, o):
            v, g, _, nh = merge_exact_long(*lists[x], *lists[y], nm)
            lists[o] = v, g
            tail[r] |= nh < nm

        chain(merge, dc)
        for k in range(dc):
            ov[r, k], og[r, k] = lists[out_src(k, dc)]
    return ov, og, tail


def exact_cn(lv, lg):
    """The general step's exact check node at q = 256, dc >= 3: the dense
    form at nm = q, its rows with a tail again through the list form; the
    list form below nm = q.  (ov, og, tail: the rows that ran a tail)."""
    if lv.shape[-1] < Q:
        return list_cn(lv, lg)
    ov, og, tail = dense_cn(lv, lg)
    if tail.any():
        ov[tail], og[tail], _ = list_cn(lv[tail], lg[tail])
    return ov, og, tail


def input_lists(kind, nm, rng, rows=ROWS, dc=DC, pads=None):
    """Rows of dc input lists as K3 builds them: a min-normalised dense
    message [256] a slot ("decoder": continuous costs; "ties": levels
    0..5; "bf16": costs rounded to bf16; "big": about half the symbols at
    or past BIG), truncated to its nm smallest (topk_message: values
    ascending, equal ones by symbol), its ids mapped by a random
    bijection (the rotation); a padded slot (pads [rows, dc]) the neutral
    list."""
    x = np.abs(rng.normal(0, 4, (rows, dc, Q))).astype(np.float32)
    if kind == "ties":
        x = rng.integers(0, 6, (rows, dc, Q)).astype(np.float32)
    elif kind == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    elif kind == "big":
        big = rng.random((rows, dc, Q)) < 0.5
        x = np.where(big, (1 + 3 * rng.random((rows, dc, Q))) * BIG, x)
        x = x.astype(np.float32)
    x = x - x.min(axis=-1, keepdims=True)
    order = np.lexsort((np.broadcast_to(np.arange(Q), x.shape), x), axis=-1)
    lv = np.take_along_axis(x, order, axis=-1)[..., :nm]
    lg = order[..., :nm]
    perm = np.stack([rng.permutation(Q) for _ in range(rows * dc)]).reshape(
        rows, dc, Q)
    lg = np.take_along_axis(perm, lg, axis=-1)
    if pads is not None:
        nv = np.full(nm, BIG, np.float32)
        nv[0] = 0
        lv = np.where(pads[..., None], nv, lv)
        lg = np.where(pads[..., None], np.arange(nm), lg)
    return lv.astype(np.float32), lg.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _jitted(name):
    """A JAX list op, jitted once (nm and nboper static)."""
    jax = pytest.importorskip("jax")
    from ems_nbldpc_tpu.ops import listcn as jlistcn

    return jax.jit(getattr(jlistcn, name),
                   static_argnums=(2, 3) if name == "fb_checknode_list"
                   else (4, 5))


def jax_cn(lv, lg, nm):
    """JAX's fb_checknode_list(..., nboper=0) on the same lists."""
    ov, og = _jitted("fb_checknode_list")(lv, lg.astype(np.int32), nm, 0)
    return np.asarray(ov), np.asarray(og)


def plain_heads(lv, lg, nm):
    """The fewest GF ids below BIG that any merge of the port's plain
    chain (listcn.list_combine, nboper = 0) yields, row by row."""
    tv, tg = torch.from_numpy(lv), torch.from_numpy(lg.astype(np.int32))
    dc = lv.shape[1]
    lists = {k: (tv[:, k], tg[:, k]) for k in range(dc)}
    least = np.full(lv.shape[0], Q)

    def merge(x, y, o):
        v, g = listcn.list_combine(*lists[x], *lists[y], nm, 0)
        lists[o] = v, g
        np.minimum(least, (v < BIG).sum(-1).numpy(), out=least)

    chain(merge, dc)
    return least


@pytest.mark.parametrize("kind", ["decoder", "ties", "bf16", "big"])
@pytest.mark.parametrize("nm", [65, 96, 128, 255, 256])
def test_dense_exact_merge_matches_jax(kind, nm):
    """The exact check node as the general step runs it at q = 256 (the
    dense form at nm = q, the list form below) equals JAX's
    ``fb_checknode_list(..., nboper=0)`` bit for bit (values and GF ids)
    on every row; at nm = q the dense form serves them (no tail)."""
    rng = np.random.default_rng(nm * 7 + len(kind))
    lv, lg = input_lists(kind, nm, rng, rows=2)
    ov, og, tail = exact_cn(lv, lg)
    jv, jg = jax_cn(lv, lg, nm)
    assert not tail.any()
    np.testing.assert_array_equal(ov.view(np.uint32), jv.view(np.uint32))
    np.testing.assert_array_equal(og, jg)


@pytest.mark.parametrize("nm", [65, 128, 256])
@pytest.mark.parametrize("kind", ["decoder", "big"])
def test_row_tail_flag_matches_the_plain_merges(nm, kind):
    """Padded slots (neutral lists: 0 at GF 0, BIG elsewhere) and inputs
    mostly at BIG make merges with fewer than nm heads: the model (the
    dense form's row flag at nm = q, the list form's merge tails below)
    flags exactly the rows where the plain chain has such a merge, and
    every row, the rerun ones too, equals JAX's outputs."""
    rng = np.random.default_rng(nm + len(kind))
    rows = 6
    pads = rng.random((rows, DC)) < 0.4
    pads[0] = [True, True, False, False]     # F[1] neutral with neutral
    pads[1] = False
    lv, lg = input_lists(kind, nm, rng, rows=rows, pads=pads)
    if kind == "big":
        lv[2:4, :, 1:] = BIG                 # one finite entry a list
    ov, og, tail = exact_cn(lv, lg)
    assert np.array_equal(tail, plain_heads(lv, lg, nm) < nm)
    assert tail.any() and (~tail).any()
    jv, jg = jax_cn(lv, lg, nm)
    np.testing.assert_array_equal(ov.view(np.uint32), jv.view(np.uint32))
    np.testing.assert_array_equal(og, jg)


def _messages(kind, rng, rows=ROWS):
    """Dense min-normalised messages [rows, 256] f32: "decoder", "ties",
    "bf16", "close" (values of one high part that differ in their low
    bits: the 32-bit keys cannot be kept)."""
    x = np.abs(rng.normal(0, 4, (rows, Q))).astype(np.float32)
    if kind == "ties":
        x = rng.integers(0, 6, (rows, Q)).astype(np.float32)
    elif kind == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    elif kind == "close":
        x = (3 + rng.integers(0, 64, (rows, Q)) * 2.0 ** -22).astype(
            np.float32)
        x[:, 0] = 0
    return x - x.min(axis=-1, keepdims=True)


@pytest.mark.parametrize("kind", ["decoder", "ties", "bf16", "close"])
@pytest.mark.parametrize("nm", [65, 96, 128, 255, 256])
def test_exact_truncation_matches_topk_message(kind, nm):
    """The exact truncation (select_exact_out over a message's values by
    symbol) gives ``minconv.topk_message``'s list, values ascending and
    equal ones by symbol, in JAX and in the port; its 32-bit keys are kept
    on every bf16 message and never on the "close" ones."""
    jax = pytest.importorskip("jax")
    from ems_nbldpc_tpu.ops.minconv import topk_message as jtopk

    from ems_nbldpc_torch.ops.minconv import topk_message as ttopk

    rng = np.random.default_rng(nm * 3 + len(kind))
    x = _messages(kind, rng)
    jv, jg = (np.asarray(a) for a in jax.jit(jtopk, static_argnums=1)(x, nm))
    tv, tg = (a.numpy() for a in ttopk(torch.from_numpy(x), nm))
    kept = []
    for r in range(ROWS):
        v, g, ok = select_exact(bits(x[r]), NONE, nm)
        kept.append(ok)
        np.testing.assert_array_equal(v, bits(jv[r]))
        np.testing.assert_array_equal(g, jg[r])
        np.testing.assert_array_equal(v, bits(tv[r]))
        np.testing.assert_array_equal(g, tg[r])
    if kind in ("ties", "bf16"):
        assert all(kept)
    if kind == "close":
        assert not any(kept)


def merge_exact_long(av, ag, bv, bg, nm):
    """merge_exact_long on one pair of ascending lists of nm (f32
    values, GF ids): (values, ids, candidates visited past the first pass,
    the GF ids below BIG)."""
    sums = bits(np.minimum(av[:, None] + bv[None, :], BIG))
    gid = (ag[:, None] ^ bg[None, :]) & 0xFF
    i, j = np.meshgrid(np.arange(nm), np.arange(nm), indexing="ij")
    first = (i + 1) * (j + 1) <= 2 * nm
    tab = np.full(Q, NONE, np.int64)
    np.minimum.at(tab, gid[first], sums[first])

    def select():
        nh = int((tab < BIG_BITS).sum())
        v, g, _ = select_exact(tab, BIG_BITS, min(nh, nm))
        return v, g, nh

    v, g, nh = select()
    visited = 0
    if nh >= nm:
        # each row's candidates past the staircase up to its first sum past
        # the bound: the sums ascend along a row
        past = ~first & (sums <= v[nm - 1])
        visited = int(past.sum())
        lowered = bool((sums[past] < tab[gid[past]]).any())
        np.minimum.at(tab, gid[past], sums[past])
        if lowered:
            v, g, nh = select()
    else:
        visited = int((~first).sum())
        np.minimum.at(tab, gid[~first], sums[~first])
        v, g, nh = select()
    out_v, out_g = v.astype(np.uint32).view(np.float32), g
    if nh < nm:
        # the tail: value BIG, each GF id as often as its candidates but
        # its head, in GF order
        left = np.bincount(gid.reshape(-1), minlength=Q) - (tab < BIG_BITS)
        fill = np.repeat(np.arange(Q), left)[:nm - nh]
        out_v = np.concatenate([out_v, np.full(len(fill), BIG, np.float32)])
        out_g = np.concatenate([out_g, fill])
    return out_v, out_g, visited, nh


@pytest.mark.parametrize("kind", ["decoder", "ties", "bf16", "few", "neutral"])
@pytest.mark.parametrize("nm", [65, 96, 128, 256])
def test_exact_list_merge_matches_jax(kind, nm):
    """The exact list form's merge (the dense form's tails and the exact
    shapes it does not take) equals JAX's ``list_combine(..., nboper=0)``
    and the port's bit for bit, tails ("few": three GF ids below BIG;
    "neutral": b the merge's identity) included; on decoder lists it visits
    few candidates past its first pass."""
    rng = np.random.default_rng(nm * 5 + len(kind))
    lv, lg = input_lists("decoder" if kind in ("few", "neutral") else kind,
                         nm, rng, rows=3, dc=2)
    if kind == "few":
        lv[:, :, 3:] = BIG
        lg[:, :, 3:] = rng.integers(0, 4, (3, 2, nm - 3))
    if kind == "neutral":
        lv[:, 1] = BIG
        lv[:, 1, 0] = 0
        lg[:, 1] = np.arange(nm)
    want = _jitted("list_combine")(
        lv[:, 0], lg[:, 0].astype(np.int32), lv[:, 1],
        lg[:, 1].astype(np.int32), nm, 0)
    tv, tg = listcn.list_combine(
        torch.from_numpy(lv[:, 0]), torch.from_numpy(lg[:, 0].astype(np.int32)),
        torch.from_numpy(lv[:, 1]), torch.from_numpy(lg[:, 1].astype(np.int32)),
        nm, 0)
    visits = []
    for r in range(3):
        v, g, n, _ = merge_exact_long(lv[r, 0], lg[r, 0], lv[r, 1],
                                      lg[r, 1], nm)
        visits.append(n)
        np.testing.assert_array_equal(v.view(np.uint32),
                                      np.asarray(want[0])[r].view(np.uint32))
        np.testing.assert_array_equal(g, np.asarray(want[1])[r])
        np.testing.assert_array_equal(v, tv[r].numpy())
        np.testing.assert_array_equal(g, tg[r].numpy())
    if kind == "decoder":
        assert np.mean(visits) < nm * nm / 4


def merge_stair(av, ag, bv, bg, nm, nboper):
    """merge_stair on one pair of staircase lists (bf16 values, BIG
    unfilled; GF ids): (values, ids)."""
    w = min(nboper, nm * nm)
    tab = np.full(Q, NONE, np.int64)
    for i in range(nm):
        wi = min(nm, w // (i + 1))
        if wi == 0:
            break
        s = torch.from_numpy((av[i] + bv[:wi]).astype(np.float32))
        b16 = (s.clamp_max(1e9).to(torch.bfloat16).view(torch.int16)
               .numpy().astype(np.int64) & 0xFFFF)
        np.minimum.at(tab, (ag[i] ^ bg[:wi]) & 0xFF, b16)
    keys = np.sort(np.where(tab != NONE, tab << 8 | np.arange(Q), DUP))[:nm]
    dup = keys == DUP
    v = torch.from_numpy((keys >> 8 & 0xFFFF).astype(np.int16)).view(
        torch.bfloat16).float().numpy()
    return (np.where(dup, BIG, v).astype(np.float32),
            np.where(dup, np.arange(nm), keys & 0xFF))


@pytest.mark.parametrize("nboper", [64, 256, 4096, 65536])
@pytest.mark.parametrize("nm", [65, 96, 128, 200, 256])
def test_staircase_selection_matches_plain(nm, nboper):
    """The staircase's truncation (bf16 keys of a message, the 256 keys
    sorted, the first nm) gives ``topk_list``'s list, and its merge (per-GF
    minima of the staircase's bf16 sums, sorted on 32-bit keys) gives
    ``list_combine(..., nboper)``'s: values, GF ids and the dup marker's
    slots; the port's at every budget, JAX's at nbOper = 64 (its staircase
    of at most 64 rows compiles in a second; the port's equals it
    elsewhere, tests/test_torch_list.py)."""
    rng = np.random.default_rng(nm + nboper)
    x = _messages("decoder", rng, rows=4)
    x[1] = rng.integers(0, 3, Q)                 # ties: few distinct values
    x[1] -= x[1].min()
    b16 = (torch.from_numpy(x).clamp_max(1e9).to(torch.bfloat16)
           .view(torch.int16).numpy().astype(np.int64) & 0xFFFF)
    keys = np.sort(b16 << 8 | np.arange(Q), axis=-1)[:, :nm]
    lv = torch.from_numpy((keys >> 8).astype(np.int16)).view(
        torch.bfloat16).float().numpy()
    lg = keys & 0xFF
    tv, tg = listcn.topk_list(torch.from_numpy(x), nm)
    np.testing.assert_array_equal(lv, tv.numpy())
    np.testing.assert_array_equal(lg, tg.numpy())
    a, b = [0, 1, 0], [2, 3, 1]
    args = (lv[a], lg[a].astype(np.int32), lv[b], lg[b].astype(np.int32))
    wants = [tuple(x.numpy() for x in listcn.list_combine(
        *map(torch.from_numpy, args), nm, nboper))]
    if nboper == 64:
        jax = pytest.importorskip("jax")
        from ems_nbldpc_tpu.ops.listcn import topk_list as jtopk

        jv, jg = jax.jit(jtopk, static_argnums=1)(x, nm)
        np.testing.assert_array_equal(lv, np.asarray(jv))
        np.testing.assert_array_equal(lg, np.asarray(jg))
        wants.append(tuple(np.asarray(x) for x in _jitted("list_combine")(
            *args, nm, nboper)))
    for r in range(3):
        v, g = merge_stair(lv[a[r]], lg[a[r]], lv[b[r]], lg[b[r]], nm, nboper)
        for want_v, want_g in wants:
            np.testing.assert_array_equal(v, want_v[r])
            np.testing.assert_array_equal(g, want_g[r])
