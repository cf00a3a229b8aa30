"""The port's channels (QAM, rotated QAM, 64-APSK, the 256-QAM 4-D channel)
and their demappers against the JAX package's.

Tables are NumPy in both packages: bit for bit.  Channel outputs: the test
makes JAX's own draws with ``jax.random`` exactly as ``channel_2d`` and
``qam256_4d`` make them (``split(key, 3)``, then ``normal``,
``uniform(minval=1e-12)`` and ``bernoulli`` in JAX's shapes), feeds them to
the port's deterministic functions and compares with the JAX function on
the same key.  Tolerance on costs: atol 1e-4 + rtol 1e-5, relative to the
cost itself on the 2-D path (both sides square the same differences; the
port multiplies by float32(1 / (2 sigma^2)) where JAX divides, and XLA may
contract products into FMAs) and relative to the row's largest cost on
the 4-D path, whose expanded form subtracts terms of the row's scale
(JAX's products sum in another order).  Decisions: the argmin is equal
wherever JAX's two best costs are further apart than the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ems_nbldpc_tpu.models import channels as jch

from ems_nbldpc_torch.models import channels as tch
from ems_nbldpc_torch.ops import cuda_demap

ATOL, RTOL = 1e-4, 1e-5
SHAPE = (4, 24)
MODIFIERS = {
    "awgn": {},
    "rayleigh": dict(rayleigh=True),
    "ssd": dict(ssd=True),
    "rayleigh+ssd": dict(rayleigh=True, ssd=True),
    "erasure": dict(erasure_prob=0.1),
    "rayleigh+erasure": dict(rayleigh=True, erasure_prob=0.1),
}
MODIFIERS_4D = {
    "awgn": {},
    "ssd": dict(ssd=True),
    "erasure": dict(erasure_prob=0.1),
    "ssd+erasure": dict(ssd=True, erasure_prob=0.1),
}
LABELINGS_2D = [("qam", "ref", False), ("qam", "gray", False),
                ("qam", "v2", False), ("qam", "ref", True)]


def specs(kind, labeling="ref", rotated=False, **mods):
    kw = dict(kind=kind, sigma_convention="snr", labeling=labeling,
              rotated=rotated, **mods)
    return jch.ChannelSpec(**kw), tch.ChannelSpec(**kw)


def jax_draws(key, spec, dim):
    """The draws ``channel_2d`` (dim 2) / ``qam256_4d`` (dim 4) make from
    ``key``, as numpy (None where the channel draws nothing)."""
    knoise, kfade, kerase = jax.random.split(key, 3)
    full = SHAPE + (dim,)
    z = jax.random.normal(knoise, full, dtype=jnp.float32)
    u = er = None
    if spec.ssd:
        u = jax.random.uniform(kfade, full, dtype=jnp.float32, minval=1e-12)
    elif spec.rayleigh and dim == 2:
        u = jax.random.uniform(kfade, SHAPE + (1,), dtype=jnp.float32,
                               minval=1e-12)
    if spec.erasure_prob > 0.0:
        er = jax.random.bernoulli(kerase, spec.erasure_prob, full)
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in (z, u, er)]


def assert_costs_close(got, want, row_scale=False):
    err = np.abs(got - want)
    scale = want.max(-1, keepdims=True) if row_scale else np.abs(want)
    tol = ATOL + RTOL * scale
    print(f"largest error {err.max():.3e} (largest cost {want.max():.1f})")
    assert (err <= tol).all(), float((err - tol).max())
    assert (got.min(-1) == 0).all()
    # decisions: equal wherever JAX's best two are clearly apart
    top2 = np.sort(want, axis=-1)[..., :2]
    clear = top2[..., 1] - top2[..., 0] > 2 * tol.max(-1)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.argmin(-1)[clear],
                                  want.argmin(-1)[clear])


# ---------------- tables ----------------

@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("labeling", ["ref", "gray", "v2"])
@pytest.mark.parametrize("q", [4, 16, 64, 256])
def test_qam_tables_equal_jax(q, labeling, rotated):
    want = jch.constellation("qam", q, rotated, labeling)
    got = tch.constellation("qam", q, rotated, labeling)
    assert got.dtype == np.float32 and got.shape == (q, 2)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("labeling", ["ref", "gray"])
def test_apsk64_and_4d_tables_equal_jax(labeling, rotated):
    assert np.array_equal(tch.constellation("apsk64", 64, rotated, labeling),
                          jch.constellation("apsk64", 64, rotated, labeling))
    got = tch.constellation_4d(labeling, rotated)
    assert got.shape == (256, 4)
    assert np.array_equal(got, jch.constellation_4d(labeling, rotated))


@pytest.mark.parametrize("convention", ["ebn0", "snr"])
@pytest.mark.parametrize("db", [-1.5, 0.0, 2.0, 12.0, 21.5])
def test_sigma_for_equal_jax(convention, db):
    js = jch.ChannelSpec(sigma_convention=convention)
    ts = tch.ChannelSpec(sigma_convention=convention)
    assert tch.sigma_for(ts, db, 0.5) == jch.sigma_for(js, db, 0.5)


# ---------------- the 2-D and 4-D channels against JAX ----------------

@pytest.mark.parametrize("mod", list(MODIFIERS))
@pytest.mark.parametrize("kind,q", [("qam", 16), ("qam", 64), ("qam", 256),
                                    ("apsk64", 64)])
def test_channel_2d_matches_jax(kind, q, mod):
    rng = np.random.default_rng(q + len(mod))
    cw = rng.integers(0, q, SHAPE)
    labelings = (LABELINGS_2D if kind == "qam"
                 else [("apsk64", "ref", False), ("apsk64", "gray", False)])
    for i, (_, labeling, rotated) in enumerate(labelings):
        js, ts = specs(kind, labeling, rotated, **MODIFIERS[mod])
        for snr in (4.0, 16.0):
            sigma = jch.sigma_for(js, snr, 0.5)
            key = jax.random.PRNGKey(100 * i + int(snr))
            want = np.asarray(jch.channel_2d(key, jnp.asarray(cw), q, sigma,
                                             js))
            z, u, er = jax_draws(key, js, 2)
            pts = torch.from_numpy(tch.table_for(ts, q))
            got = tch.channel_2d_from_draws(torch.from_numpy(cw), pts, z, u,
                                            er, sigma, ts.erasure_prob)
            assert got.shape == (*SHAPE, q) and got.dtype == torch.float32
            assert_costs_close(got.numpy(), want)


@pytest.mark.parametrize("labeling", ["ref", "gray"])
@pytest.mark.parametrize("mod", list(MODIFIERS_4D))
def test_qam256_4d_matches_jax(mod, labeling):
    rng = np.random.default_rng(7)
    cw = rng.integers(0, 256, SHAPE)
    js, ts = specs("qam256_4d", labeling, **MODIFIERS_4D[mod])
    for snr in (6.0, 14.0, 20.0):
        sigma = jch.sigma_for(js, snr, 0.5)
        key = jax.random.PRNGKey(int(snr))
        want = np.asarray(jch.qam256_4d(key, jnp.asarray(cw), sigma, js))
        z, u, er = jax_draws(key, js, 4)
        cand = torch.from_numpy(tch.table_for(ts, 256))
        got = tch.qam256_4d_from_draws(torch.from_numpy(cw), cand, z, u, er,
                                       sigma, ts.erasure_prob)
        assert got.shape == (*SHAPE, 256)
        assert_costs_close(got.numpy(), want, row_scale=True)


def test_4d_erasures_act_on_the_receiver_only():
    """The 4-D channel keeps the reference's quirk: the signal carries the
    raw fade, only the receiver's att is erased and renormalised.  The
    2-D ordering (transmit after the erasure) gives another output."""
    rng = np.random.default_rng(3)
    cw = torch.from_numpy(rng.integers(0, 256, SHAPE))
    js, ts = specs("qam256_4d", ssd=True, erasure_prob=0.1)
    sigma = jch.sigma_for(js, 12.0, 0.5)
    key = jax.random.PRNGKey(5)
    z, u, er = jax_draws(key, js, 4)
    assert er.any()
    cand = torch.from_numpy(tch.table_for(ts, 256))
    got = tch.qam256_4d_from_draws(cw, cand, z, u, er, sigma, 0.1)
    y, att = tch.modulate_4d(cw, cand, z, u, er, sigma, 0.1)
    # the signal carries the raw fade where the receiver assumes 0
    raw = torch.sqrt(-torch.log(u))
    assert torch.equal(y, raw * cand[cw] + sigma * z)
    assert (att[er] == 0).all()
    # the 2-D ordering: transmit with the erased, renormalised att
    y2 = att * cand[cw] + sigma * z
    other = tch.demap_4d_plain(y2, att, cand, tch.inv_two_sigma2(sigma))
    # survivors too: the receiver renormalises a fade the signal lacks
    rows = er.any(-1)
    assert not torch.allclose(got[rows], other[rows], atol=1e-2)
    assert not torch.allclose(got[~rows], other[~rows], atol=1e-2)
    want = np.asarray(jch.qam256_4d(key, jnp.asarray(cw.numpy()), sigma, js))
    assert_costs_close(got.numpy(), want, row_scale=True)


# ---------------- draws ----------------

@pytest.mark.parametrize("kind,dim,mods", [
    ("qam", 2, dict(rayleigh=True)),
    ("qam", 2, dict(ssd=True, erasure_prob=0.2)),
    ("qam", 2, dict(rayleigh=True, erasure_prob=0.1)),
    ("qam256_4d", 4, dict(ssd=True, erasure_prob=0.1)),
])
def test_draw_statistics(kind, dim, mods):
    """From a torch generator: unit-normal noise (so std sigma after
    scaling), E[att^2] = 1 with the erasure renormalisation, the erasure
    share p, fades of JAX's shapes, and the same draws for the same seed."""
    spec = tch.ChannelSpec(kind=kind, sigma_convention="snr", **mods)
    shape = (64, 500)
    gen = torch.Generator().manual_seed(1)
    z, u, er = tch.channel_draws(gen, shape, spec, dim)
    assert z.shape == (*shape, dim)
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1) < 0.02
    fade_dims = dim if spec.ssd else 1
    assert u.shape == (*shape, fade_dims) and float(u.min()) >= 1e-12
    att = tch._erase(torch.sqrt(-torch.log(u)), er, spec.erasure_prob)
    assert abs(float((att * att).mean()) - 1.0) < 0.02
    if spec.erasure_prob:
        assert er.shape == (*shape, dim) and er.dtype == torch.bool
        assert abs(float(er.float().mean()) - spec.erasure_prob) < 0.01
    else:
        assert er is None
    again = tch.channel_draws(torch.Generator().manual_seed(1), shape, spec,
                              dim)
    for a, b in zip((z, u, er), again):
        assert a is b is None or torch.equal(a, b)
    other = tch.channel_draws(torch.Generator().manual_seed(2), shape, spec,
                              dim)
    assert not torch.equal(z, other[0])


def test_noise_std_is_sigma():
    spec = tch.ChannelSpec(kind="qam", sigma_convention="snr")
    sigma = tch.sigma_for(spec, 10.0, 0.5)
    cw = torch.zeros((64, 500), dtype=torch.int64)
    gen = torch.Generator().manual_seed(4)
    z, u, er = tch.channel_draws(gen, cw.shape, spec, 2)
    pts = torch.from_numpy(tch.constellation("qam", 16))
    y, att = tch.modulate_2d(cw, pts, z, u, er, sigma, 0.0)
    assert torch.equal(att, torch.ones_like(att))
    noise = y - pts[0]
    assert abs(float(noise.std()) / sigma - 1.0) < 0.02


# ---------------- simulate, the wrapper on the CPU, guards ----------------

@pytest.mark.parametrize("kind,q,mods", [
    ("qam", 4, dict(rotated=True, erasure_prob=0.1)),
    ("qam", 16, dict(rayleigh=True)),
    ("qam", 64, dict(ssd=True, labeling="gray")),
    ("qam", 256, dict(labeling="v2", rayleigh=True, erasure_prob=0.05)),
    ("apsk64", 64, dict(rayleigh=True, labeling="gray")),
    ("qam256_4d", 256, dict(ssd=True, erasure_prob=0.1)),
])
def test_simulate_every_kind_on_cpu_launches_nothing(kind, q, mods):
    spec = tch.ChannelSpec(kind=kind, sigma_convention="snr", **mods)
    cw = torch.from_numpy(np.random.default_rng(q).integers(0, q, (8, 40)))
    before = cuda_demap.launches
    gen = torch.Generator().manual_seed(9)
    cost = tch.simulate(gen, cw, q, spec, 30.0, 0.5)
    assert cuda_demap.launches == before
    assert cost.shape == (8, 40, q) and cost.dtype == torch.float32
    assert bool(torch.isfinite(cost).all())
    assert (cost.min(-1).values == 0).all()
    # at 30 dB the best point is mostly the one sent (deep fades and
    # erased components leave some symbols undecided)
    assert float((cost.argmin(-1) == cw).float().mean()) > 0.5
    again = tch.simulate(torch.Generator().manual_seed(9), cw, q, spec, 30.0,
                         0.5)
    assert torch.equal(cost, again)


@pytest.mark.parametrize("kind,q,labeling", [
    ("qam", 4, "gray"), ("qam", 16, "v2"), ("qam", 64, "ref"),
    ("apsk64", 64, "gray"), ("qam256_4d", 256, "gray")])
def test_noiseless_decisions_are_the_codeword(kind, q, labeling):
    spec = tch.ChannelSpec(kind=kind, labeling=labeling, rotated=True)
    tab = torch.from_numpy(tch.table_for(spec, q))
    cw = torch.from_numpy(np.random.default_rng(0).integers(0, q, (3, 50)))
    dim = tab.shape[1]
    zero = torch.zeros((3, 50, dim))
    f = (tch.qam256_4d_from_draws if kind == "qam256_4d"
         else tch.channel_2d_from_draws)
    cost = f(cw, tab, zero, None, None, 0.3, 0.0)
    assert torch.equal(cost.argmin(-1), cw)


@pytest.mark.parametrize("kind,q,labeling,erasure", [
    ("qam", 32, "ref", 0.0),        # not a square
    ("qam", 8, "gray", 0.0),
    ("qam", 2, "ref", 0.0),
    ("qam", 16, "apsk", 0.0),       # unknown labeling
    ("apsk64", 16, "ref", 0.0),     # apsk64 needs q = 64
    ("apsk64", 256, "ref", 0.0),
    ("apsk64", 64, "v2", 0.0),
    ("qam256_4d", 64, "ref", 0.0),  # 4-D needs q = 256
    ("qam256_4d", 256, "v2", 0.0),
    ("qam", 16, "ref", 1.0),        # every component erased
    ("psk8", 8, "ref", 0.0),        # unknown kind
])
def test_simulate_rejects_what_the_tables_cannot_serve(kind, q, labeling,
                                                       erasure):
    """ValueError before anything is drawn (the generator is untouched)."""
    spec = tch.ChannelSpec(kind=kind, labeling=labeling, erasure_prob=erasure,
                           sigma_convention="snr")
    cw = torch.zeros((2, 8), dtype=torch.int64)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    with pytest.raises(ValueError):
        tch.simulate(gen, cw, q, spec, 10.0, 0.5)
    assert torch.equal(gen.get_state(), state)


def test_demap_wrapper_rejects_what_the_kernel_cannot_take():
    y = torch.zeros((2, 3, 2))
    pts = torch.from_numpy(tch.constellation("qam", 16))
    with pytest.raises(ValueError, match="float32"):
        cuda_demap.demap_2d(y.double(), y.double(), pts, 1.0)
    with pytest.raises(ValueError, match="one shape"):
        cuda_demap.demap_2d(y, torch.zeros((2, 3, 1)), pts, 1.0)
    with pytest.raises(ValueError, match=r"\[q, 4\]"):
        cuda_demap.demap_4d(torch.zeros((2, 3, 4)), torch.zeros((2, 3, 4)),
                            pts, 1.0)
    with pytest.raises(ValueError, match="power of two"):
        cuda_demap.demap_2d(y, y, torch.zeros((36, 2)), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_demap.demap_2d(y.transpose(0, 1), y.transpose(0, 1), pts, 1.0)
    # the CPU wrapper is the plain version
    att = torch.rand((2, 3, 2))
    y = torch.randn((2, 3, 2))
    assert torch.equal(cuda_demap.demap_2d(y, att, pts, 0.7),
                       tch.demap_2d_plain(y, att, pts, 0.7))


# ---------------- on the card ----------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind,q,mods", [
    ("qam", 256, dict(rayleigh=True, erasure_prob=0.1)),
    ("qam", 16, dict(ssd=True)),
    ("qam", 4, {}),
    ("apsk64", 64, dict(rayleigh=True)),
    ("qam256_4d", 256, dict(ssd=True, erasure_prob=0.1)),
])
def test_demap_kernel_equals_plain_on_card(kind, q, mods):
    """K8 against its plain version on the same draws, bit for bit (card
    only; chip_smoke.py phase 3d runs the full-width shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    spec = tch.ChannelSpec(kind=kind, sigma_convention="snr", **mods)
    dim = 4 if kind == "qam256_4d" else 2
    gen = torch.Generator(device="cuda").manual_seed(3)
    cw = torch.randint(0, q, (5, 37), generator=gen, device="cuda")
    z, u, er = tch.channel_draws(gen, cw.shape, spec, dim)
    tab = torch.from_numpy(tch.table_for(spec, q)).cuda()
    sigma = tch.sigma_for(spec, 12.0, 0.5)
    inv = tch.inv_two_sigma2(sigma)
    mod = tch.modulate_4d if dim == 4 else tch.modulate_2d
    y, att = mod(cw, tab, z, u, er, sigma, spec.erasure_prob)
    plain = tch.demap_4d_plain if dim == 4 else tch.demap_2d_plain
    kernel = cuda_demap.demap_4d if dim == 4 else cuda_demap.demap_2d
    before = cuda_demap.launches
    got = kernel(y, att, tab, inv)
    assert cuda_demap.launches == before + 1
    assert torch.equal(got, plain(y, att, tab, inv))
