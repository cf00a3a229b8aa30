"""K1's dense merge (``csrc/fb_checknode.cu``, ``dense_merge`` and the
dense mode's slots): a NumPy model of the kernel's schedule and index
algebra, held against the port's and the JAX package's dense
min-convolution and dense check node, bit for bit.

The model follows the source: lane l owns the outputs PER lo .. PER lo +
PER - 1 (PER = q / 32, or 1 below q = 32 with lo = l mod q); chunk c of
one operand (a broadcast) meets chunk c ^ lo of the other; at q = 256 a
lane reads that chunk's two 16-byte halves in the order bit 2 of the lane
sets (hl), and holds its outputs in the same order; the prologue parks
each input where the later of its two chain passes overwrites it; and
every pass reads all it needs before any lane stores (the kernel's
``__syncwarp`` between them).  Each candidate is one f32 add and a minimum
is exact, so the order of the candidates cannot change a result; the
three-input integer minimum holds only where every operand's sign bit is
clear, which the model checks as the kernel does, row by row.  The kernel
itself runs only on the card (``chip_smoke.py`` phase 3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ems_nbldpc_tpu.ops import minconv as jmc

from ems_nbldpc_torch.ops import minconv as tmc

QS = [2, 4, 16, 32, 64, 128, 256]
INF_COST = np.float32(1e9)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: under the tier-1 run's workers, torch's
    per-core threads on these small tensors cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def per(q):
    return max(q // 32, 1)


def nch(q):
    return min(q, 32)


def live_lanes(q):
    """The lanes that store (lanes past q, at q < 32, hold copies)."""
    return np.arange(min(q, 32))


def coset(lane, q):
    """lo: the coset of outputs lane ``lane`` owns, PER lo .. PER lo +
    PER - 1."""
    return lane & (nch(q) - 1)


def half(lane, q):
    """hl: at PER = 8 the half (0 or 4) of a chunk that lane ``lane`` loads
    first, bit 2 of the lane; 0 otherwise."""
    return coset(lane, q) & 4 if per(q) == 8 else 0


def chunk_positions(j, q, hl=0):
    """The symbols, in register order, that ``load_chunk`` reads and
    ``store_chunk`` writes for chunk j: register R holds PER j + (R ^ hl)
    (at PER = 8 two 16-byte halves, the one at hl first)."""
    return per(q) * j + (np.arange(per(q)) ^ hl)


def schedule(q):
    """Every candidate the kernel forms, in its order: (lane, c, T, t2, a,
    s) with u's symbol a = PER c + t2, the output s = PER lo + (T ^ hl) in
    register T, and v's symbol read from register t2 ^ T."""
    p = per(q)
    for lane in live_lanes(q):
        lo, hl = coset(lane, q), half(lane, q)
        for c in range(nch(q)):
            vpos = chunk_positions(c ^ lo, q, hl)
            for t in range(p):
                for t2 in range(p):
                    yield (lane, c, t, t2, p * c + t2, p * lo + (t ^ hl),
                           vpos[t2 ^ t])


def merge_model(u, v, q, int_min, round_bf16=False):
    """``dense_merge`` on [R, q] operands: returns the outputs [R, lanes,
    PER] of each live lane in its registers, in the kernel's candidate
    order.
    ``int_min``: two candidates a three-input signed minimum of their f32
    bits (the caller guarantees no sign bit is set), else a float minimum
    one at a time."""
    p, lanes = per(q), live_lanes(q)
    o = np.full((u.shape[0], len(lanes), p), np.inf, np.float32)
    for c in range(nch(q)):
        a = u[:, chunk_positions(c, q)]                        # [R, PER]
        b = np.stack([v[:, chunk_positions(c ^ coset(lane, q), q,
                                           half(lane, q))]
                      for lane in lanes], axis=1)              # [R, lanes, PER]
        for t in range(p):
            cand = [a[:, None, t2] + b[:, :, t2 ^ t] for t2 in range(p)]
            if int_min and p >= 2:
                oi = o[:, :, t].view(np.int32)
                for t2 in range(0, p, 2):
                    oi = np.minimum(oi, np.minimum(cand[t2].view(np.int32),
                                                   cand[t2 + 1].view(np.int32)))
                o[:, :, t] = oi.view(np.float32)
            else:
                for t2 in range(p):
                    o[:, :, t] = np.minimum(o[:, :, t], cand[t2])
    if round_bf16:
        o = bf16(o)
    return o


def store_outputs(mem, o, q):
    """Each live lane's outputs stored as ``store_chunk`` stores them."""
    for i, lane in enumerate(live_lanes(q)):
        mem[:, chunk_positions(coset(lane, q), q, half(lane, q))] = o[:, i]


def bf16(x):
    """Round float32 to bf16 (nearest even), back in float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def make_vectors(shape, kind, seed):
    """Seeded costs: "uniform" continuous, "ties" a few integer levels with
    INF_COST entries, "bf16" values a bf16 tensor holds (INF_COST too)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return (rng.random(shape) * 9).astype(np.float32)
    v = rng.integers(0, 6, shape).astype(np.float32)
    if kind == "bf16":
        v += rng.random(shape).astype(np.float32)
    v[rng.random(shape) < 0.3] = INF_COST
    return bf16(v) if kind == "bf16" else v


def merge_vectors(u, v, q, int_min=True, round_bf16=False):
    """The model's dense merge of [R, q] vectors -> [R, q]."""
    out = np.full_like(u, np.nan)
    store_outputs(out, merge_model(u, v, q, int_min, round_bf16), q)
    return out


@pytest.mark.parametrize("q", QS)
def test_schedule_forms_every_candidate_once(q):
    """Over the live lanes, every (a, s) pair is formed exactly once, each
    by the lane whose registers hold s, and the v symbol it reads is
    a ^ s."""
    seen = np.zeros((q, q), np.int64)
    owner = {}
    for lane in live_lanes(q):
        for s in chunk_positions(coset(lane, q), q, half(lane, q)):
            assert s not in owner
            owner[s] = lane
    assert sorted(owner) == list(range(q))
    for lane, c, t, t2, a, s, vsym in schedule(q):
        assert owner[s] == lane
        assert vsym == a ^ s
        seen[a, s] += 1
    assert (seen == 1).all()


def bank_groups(words):
    """The four-bank groups (16 bytes) that 16-byte accesses at these word
    offsets meet."""
    return [w % 32 // 4 for w in words]


def test_half_order_keeps_the_lanes_off_each_others_banks():
    """At q = 256 a 16-byte load or store is served in 4 phases of 8
    lanes.  Lanes 8p .. 8p+7 read chunks c ^ l, 32 bytes apart: in the
    lane's half order (bit 2 of the lane first) each of the two loads,
    and each store of the outputs, meets 8 distinct bank groups; in one
    order for every lane they meet 4, two lanes each."""
    q = 256
    for c in range(32):
        for phase in range(4):
            lanes = range(8 * phase, 8 * phase + 8)
            for first in (0, 1):
                loads = [chunk_positions(c ^ coset(l, q), q, half(l, q))
                         [4 * first] for l in lanes]
                stores = [chunk_positions(coset(l, q), q, half(l, q))
                          [4 * first] for l in lanes]
                assert len(set(bank_groups(loads))) == 8
                assert len(set(bank_groups(stores))) == 8
                one = [chunk_positions(c ^ coset(l, q), q)[4 * first]
                       for l in lanes]
                assert len(set(bank_groups(one))) == 4
            # the operand every lane reads is one address: a broadcast
            assert len({tuple(chunk_positions(c, q)) for _ in lanes}) == 1


@pytest.mark.parametrize("kind", ["uniform", "ties", "bf16"])
@pytest.mark.parametrize("q", QS)
def test_model_merge_matches_minconv_xor(q, kind):
    """The model's merge (both minima) against ``minconv_xor`` of both
    packages, bit for bit; on bf16 values also with the kernel's rounding
    of each output against the bf16 tensors' own (each sum rounded)."""
    u = make_vectors((5, q), kind, seed=q)
    v = make_vectors((5, q), kind, seed=q + 1)
    u[0], v[0] = u[1], u[1]                          # ties within a row
    want = tmc.minconv_xor(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(
        want, np.asarray(jmc.minconv_xor(jnp.asarray(u), jnp.asarray(v))))
    for int_min in (True, False):
        np.testing.assert_array_equal(merge_vectors(u, v, q, int_min), want)
    if kind == "bf16":
        tb = tmc.minconv_xor(torch.from_numpy(u).to(torch.bfloat16),
                             torch.from_numpy(v).to(torch.bfloat16))
        jb = jmc.minconv_xor(jnp.asarray(u, jnp.bfloat16),
                             jnp.asarray(v, jnp.bfloat16))
        got = merge_vectors(u, v, q, True, round_bf16=True)
        np.testing.assert_array_equal(got, tb.float().numpy())
        np.testing.assert_array_equal(got, np.asarray(jb, np.float32))


def home(k, dc):
    """The slot that parks input k: F[0] and B[dc-1] open the chains; a
    middle input waits where the later of its two passes (k forward,
    dc-1-k backward) overwrites it."""
    if k == 0 or (k <= dc - 2 and 2 * k >= dc - 1):
        return ("F", k)
    return ("B", k)


def fb_model(vr, valid, int_min=True, round_bf16=False):
    """The dense mode's row of the kernel on rotated rows vr [R, dc, q]:
    mask, park, the chains' passes, the middle merges two a pass, the
    epilogue's reads; every slot carries a tag of what it holds, and each
    read checks it.  Returns [R, dc, q]."""
    r, dc, q = vr.shape
    L = dc - 2
    if valid is not None:
        delta = np.full(q, INF_COST, np.float32)
        delta[0] = 0
        vr = np.where(valid[:, :, None], vr, delta)
    mem, tag = {}, {}

    def put(slot, value, what):
        mem[slot], tag[slot] = value.copy(), what

    if dc == 1:
        delta = np.full((r, q), INF_COST, np.float32)
        delta[:, 0] = 0
        put(("F", 0), delta, "delta")
    for k in range(dc if dc > 1 else 0):
        put(home(k, dc), vr[:, k], ("in", k))
    # the row's minima are integer ones where no parked input has its
    # sign bit set (sums, minima and roundings of such values keep it
    # clear); a row with one takes the float minima
    nonneg = ~np.signbit(vr).any(axis=(1, 2))

    def merge_pass(pairs, dests):
        """pairs: [(slot u, tag, slot v, tag)]; every read before any
        store."""
        outs = []
        for su, tu, sv, tv in pairs:
            assert tag[su] == tu and tag[sv] == tv, (su, tag[su], tu)
            o = np.empty((r, len(live_lanes(q)), per(q)), np.float32)
            for rows, im in ((nonneg, int_min), (~nonneg, False)):
                o[rows] = merge_model(mem[su][rows], mem[sv][rows], q, im,
                                      round_bf16)
            outs.append(o)
        for (slot, what), o in zip(dests, outs):
            mem.setdefault(slot, np.full((r, q), np.nan, np.float32))
            store_outputs(mem[slot], o, q)
            tag[slot] = what

    for st in range(1, L + 1):
        kb = dc - 1 - st
        merge_pass([(home(st, dc), ("in", st), ("F", st - 1),
                     ("F", st - 1) if st > 1 else ("in", 0)),
                    (home(kb, dc), ("in", kb), ("B", kb + 1),
                     ("B", kb + 1) if kb < L else ("in", dc - 1))],
                   [(("F", st), ("F", st)), (("B", kb), ("B", kb))])
    for i0 in range(1, L + 1, 2):
        idx = [i0, i0 + 1] if i0 < L else [i0]
        merge_pass([(("F", i - 1), ("F", i - 1) if i > 1 else ("in", 0),
                     ("B", i + 1), ("B", i + 1) if i < L else ("in", dc - 1))
                    for i in idx],
                   [(("B", i + 1), ("out", i)) for i in idx])
    out = np.empty((r, dc, q), np.float32)
    for k in range(dc):
        if k <= L:
            slot = ("B", k + 1)
            assert tag[slot] == (("out", k) if k else
                                 ("B", 1) if L else ("in", 1))
        else:
            slot = ("F", max(L, 0))
            assert tag[slot] == (("F", L) if L > 0 else
                                 ("in", 0) if dc == 2 else "delta")
        out[:, k] = mem[slot]
    return out


@pytest.mark.parametrize("kind", ["uniform", "ties", "bf16"])
@pytest.mark.parametrize("dc", [1, 2, 3, 5])
@pytest.mark.parametrize("q", [4, 64, 256])
def test_model_checknode_matches_fb_checknode_dense(q, dc, kind):
    """The model's F/B check node (its slots, parking and pass order)
    against ``fb_checknode_dense`` of both packages, with a valid mask;
    on bf16 values also rounded after each merge and the outputs in bf16
    (as the bare entry returns them; it takes no mask), against the port's
    dense check node on bf16 tensors."""
    rng = np.random.default_rng(q * dc)
    vr = make_vectors((4, dc, q), kind, seed=q + dc)
    valid = rng.random((4, dc)) < 0.75
    valid[:, 0] = True
    want = tmc.fb_checknode_dense(torch.from_numpy(vr),
                                  torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(
        want, np.asarray(jmc.fb_checknode_dense(jnp.asarray(vr),
                                                jnp.asarray(valid))))
    np.testing.assert_array_equal(fb_model(vr, valid), want)
    np.testing.assert_array_equal(fb_model(vr, None),
                                  tmc.fb_checknode_dense(
                                      torch.from_numpy(vr)).numpy())
    if kind == "bf16":
        tb = tmc.fb_checknode_dense(torch.from_numpy(vr).to(torch.bfloat16))
        np.testing.assert_array_equal(
            bf16(fb_model(vr, None, round_bf16=True)), tb.float().numpy())


def test_signed_order_of_nonnegative_bits_is_the_float_order():
    """f32 values with the sign bit clear (+0, subnormals, the costs,
    INF_COST, +inf) order as their bits do as signed 32-bit integers, and
    equal values have equal bits: the integer minimum returns the float
    minimum's bits."""
    rng = np.random.default_rng(5)
    vals = np.concatenate([
        np.array([0.0, 1e-45, 1e-38, 0.3, 1.0, 9.0, 1e5, 1e9, 2e9, np.inf],
                 np.float32),
        (rng.random(500) * 40).astype(np.float32),
        rng.integers(0, 6, 200).astype(np.float32)])
    assert not np.signbit(vals).any()
    bits = vals.view(np.int32)
    np.testing.assert_array_equal(np.argsort(vals, kind="stable"),
                                  np.argsort(bits, kind="stable"))
    a, b = vals[:, None], vals[None, :]
    np.testing.assert_array_equal(np.minimum(bits[:, None], bits[None, :]),
                                  np.minimum(a, b).view(np.int32))


@pytest.mark.parametrize("q", [64, 256])
def test_negative_rows_take_the_float_minima(q):
    """A row with a negative input (or -0) breaks the bits' order: the
    integer minimum alone gets it wrong, and the model, which like the
    kernel sends such a row to the float minima, gets it right."""
    v = make_vectors((3, 4, q), "uniform", seed=q)
    v[1] -= 4.0
    v[2, 1, 7] = -0.0
    want = tmc.fb_checknode_dense(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(fb_model(v, None), want)
    u, w = v[1, 0][None], v[1, 1][None]
    wrong = merge_vectors(u, w, q, int_min=True)
    assert not np.array_equal(wrong, tmc.minconv_xor(
        torch.from_numpy(u), torch.from_numpy(w)).numpy())
    assert np.signbit(v[2]).any() and not (v[2] < 0).any()
