"""The dense min-conv check node: the port against the JAX package.

Every comparison is bit for bit (``assert_array_equal``): each candidate
of a merge is one f32 add and min is exact, so the loop order over the
candidates cannot change a result.  Inputs come from a seeded numpy
generator: "uniform" draws continuous costs, "ties" a few integer levels
truncated to the nm best (so INF entries and equal values both occur)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ems_nbldpc_tpu.ops import minconv as jmc

from ems_nbldpc_torch.ops import minconv as tmc


def make_rows(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        v = rng.integers(0, 6, shape).astype(np.float32)
        return np.array(jmc.ems_input_truncate(jnp.asarray(v),
                                               max(shape[-1] // 4, 1)))
    return (rng.random(shape) * 9).astype(np.float32)


def valid_mask(t, dc, seed):
    """[t, dc] bool, each row with at least one valid slot."""
    valid = np.random.default_rng(seed).random((t, dc)) < 0.7
    valid[:, 0] = True
    return valid


@pytest.mark.parametrize("kind", ["uniform", "ties"])
@pytest.mark.parametrize("dc", [1, 2, 3, 5])
@pytest.mark.parametrize("q", [4, 16, 64, 256])
def test_dense_cn_matches_jax(q, dc, kind):
    t = 6
    v = make_rows((t, dc, q), kind, seed=q + dc)
    valid = valid_mask(t, dc, seed=q * dc)
    jv, tv = jnp.asarray(v), torch.from_numpy(v)
    np.testing.assert_array_equal(
        tmc.fb_checknode_dense(tv).numpy(),
        np.asarray(jmc.fb_checknode_dense(jv)))
    np.testing.assert_array_equal(
        tmc.fb_checknode_dense(tv, torch.from_numpy(valid)).numpy(),
        np.asarray(jmc.fb_checknode_dense(jv, jnp.asarray(valid))))
    # the two-input merge itself, on every pair of neighbouring messages
    a, b = v, np.roll(v, 1, axis=1)
    np.testing.assert_array_equal(
        tmc.minconv_xor(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jmc.minconv_xor(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("dc", [1, 2])
@pytest.mark.parametrize("q,nm", [(16, 4), (256, 32)])
def test_topk_cn_short_rows_take_the_dense_cn(q, nm, dc):
    """Rows of dc <= 2 have no merge to truncate: ``fb_checknode_topk``
    routes them (and their ``valid`` mask) to the dense CN, as JAX does."""
    v = make_rows((8, dc, q), "ties", seed=nm + dc)
    valid = valid_mask(8, dc, seed=dc)
    for mask in (None, valid):
        want = jmc.fb_checknode_topk(
            jnp.asarray(v), nm, None if mask is None else jnp.asarray(mask))
        got = tmc.fb_checknode_topk(
            torch.from_numpy(v), nm,
            None if mask is None else torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("q,nm", [(16, 5), (64, 12)])
def test_topk_cn_valid_mask_matches_jax(q, nm):
    v = make_rows((10, 4, q), "uniform", seed=q)
    valid = valid_mask(10, 4, seed=nm)
    want = jmc.fb_checknode_topk(jnp.asarray(v), nm, jnp.asarray(valid))
    got = tmc.fb_checknode_topk(torch.from_numpy(v), nm,
                                torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
