"""The port's pooling ops (``ops/gem.py``, ``ops/pooling.py``, ``ops/pca.py``)
and the demo's domain router (``parallel/ep.py``) against the JAX
package's, on the CPU in float32, inputs from numpy seeds.

Tolerances: GeM rtol 1e-5 (float32 means of powers); max / mean pooling
and R-MAC 1e-6; the R-MAC region lists equal. The SVD's sign of each
component is the solver's choice (LAPACK here, XLA in the JAX package,
cuSOLVER on the card), so components agree up to a sign per row (1e-4)
and projections through their pairwise distances (1e-4 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from anyloc_tpu.ops import gem as jgem
from anyloc_tpu.ops import pca as jpca
from anyloc_tpu.ops import pooling as jpool
from anyloc_tpu.parallel.ep import route_by_domain as jax_route

from anyloc_tpu_torch.ops import gem, pca, pooling
from anyloc_tpu_torch.parallel.ep import route_by_domain

torch.set_num_threads(2)


def _x(seed, *shape, positive=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.abs(x) if positive else x


@pytest.mark.parametrize("p", [3.0, 2.5])
@pytest.mark.parametrize("use_abs", [False, True])
@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_gem_pool_matches_jax(p, use_abs, eps):
    """Signed GeM of a non-integer p takes d ** p of negative values: NaN
    in torch and in XLA alike, so the NaNs must sit in the same places."""
    x = _x(0, 3, 50, 16)
    got = gem.gem_pool(torch.from_numpy(x), p=p, use_abs=use_abs, eps=eps).numpy()
    want = np.asarray(jgem.gem_pool(jnp.asarray(x), p=p, use_abs=use_abs, eps=eps))
    assert got.shape == (3, 16)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if p == 2.5 and not use_abs:
        assert np.isnan(got).any()      # the case the comparison is about
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("p", [3.0, 2.5])
def test_gem_pool_spatial_matches_jax(p):
    x = _x(1, 2, 7, 9, 12)     # signed: the clamp at eps matters
    got = gem.gem_pool_spatial(torch.from_numpy(x), p=p).numpy()
    want = np.asarray(jgem.gem_pool_spatial(jnp.asarray(x), p=p))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", ["global_max_pool", "global_avg_pool", "mac_spatial",
                                  "spoc_spatial", "rmac_spatial"])
def test_pooling_matches_jax(name):
    x = _x(2, 2, 9, 12, 8)
    got = getattr(pooling, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jpool, name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("h,w,levels", [(7, 7, 3), (9, 12, 3), (12, 9, 4), (5, 40, 2),
                                        (1, 1, 3), (37, 73, 3)])
def test_rmac_regions_equal_jax(h, w, levels):
    assert pooling.rmac_regions(h, w, levels) == jpool.rmac_regions(h, w, levels)


def _sign_aligned(got, want):
    """Rows of ``got`` flipped to ``want``'s sign (the SVD's sign freedom)."""
    s = np.sign(np.sum(got * want, axis=1, keepdims=True))
    return got * np.where(s == 0, 1, s)


def _pdist(x):
    return np.linalg.norm(x[:, None] - x[None], axis=-1)


@pytest.mark.parametrize("whiten", [False, True])
def test_pca_fit_matches_jax_up_to_sign(whiten):
    # a spectrum with distinct singular values: components are unique up to sign
    x = (_x(3, 60, 24) * np.linspace(3, 0.2, 24)).astype(np.float32)
    mean, comps, scale = pca.pca_fit(torch.from_numpy(x), 8, whiten=whiten)
    jm, jc, js = jpca.pca_fit(jnp.asarray(x), 8, whiten=whiten)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(scale.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_allclose(_sign_aligned(comps.numpy(), np.asarray(jc)), np.asarray(jc),
                               atol=1e-4)
    got = pca.pca_transform(torch.from_numpy(x), mean, comps, scale).numpy()
    want = np.asarray(jpca.pca_transform(jnp.asarray(x), jm, jc, js))
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=1e-4, atol=1e-4)


def test_pca_fit_refuses_more_components_than_rank():
    with pytest.raises(ValueError, match="exceeds min"):
        pca.pca_fit(torch.zeros(5, 8), 6)


@pytest.mark.parametrize("case", ["plain", "whiten", "low_factor", "fallback"])
def test_reduce_pca_matches_jax(case):
    """The projected data through its pairwise distances, which no sign
    choice moves: both ``low_factor`` branches (enough samples, and the
    ``fallback`` pre-projection when there are fewer samples than dims)."""
    n, d = (20, 48) if case == "fallback" else (60, 24)
    spectrum = np.linspace(3, 0.2, d).astype(np.float32)
    train = _x(4, n, d) * spectrum
    test = _x(5, 9, d) * spectrum
    kw = {"plain": dict(lower_dim=6), "whiten": dict(lower_dim=6, whitening=True),
          "low_factor": dict(lower_dim=8, low_factor=0.25),
          "fallback": dict(lower_dim=8, low_factor=0.5, fallback=16)}[case]
    got_tr, got_te = pca.reduce_pca(train, test, device="cpu", **kw)
    want_tr, want_te = jpca.reduce_pca(train, test, **kw)
    assert got_tr.shape == np.asarray(want_tr).shape and got_te.shape == np.asarray(want_te).shape
    for g, w in ((got_tr, want_tr), (got_te, want_te)):
        w = np.asarray(w)
        np.testing.assert_allclose(_pdist(g), _pdist(w), rtol=1e-4, atol=1e-4 * np.abs(w).max())
    both_g = np.concatenate([got_tr, got_te])
    both_w = np.concatenate([np.asarray(want_tr), np.asarray(want_te)])
    cos = np.abs((both_g * both_w).sum(0)) / (np.linalg.norm(both_g, axis=0)
                                              * np.linalg.norm(both_w, axis=0))
    assert cos.min() >= 1 - 1e-4, cos     # |cos| per component


def test_concat_desc_dists_clusters_matches_jax():
    centers, descs = _x(6, 4, 16), _x(7, 10, 16)
    got = pca.concat_desc_dists_clusters(centers, descs, device="cpu").numpy()
    want = np.asarray(jpca.concat_desc_dists_clusters(centers, descs))
    assert got.shape == (10, 64)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_route_by_domain_equals_jax():
    """Routes equal: domain centroids near distinct images' GeM, so no
    argmax sits on a near tie."""
    descs = _x(8, 6, 30, 16)
    g = np.asarray(jgem.gem_pool(jnp.asarray(descs), use_abs=True))
    cents = g[[0, 2, 4]] + 0.01 * _x(9, 3, 16)
    got = route_by_domain(torch.from_numpy(descs), torch.from_numpy(cents)).numpy()
    want = np.asarray(jax_route(jnp.asarray(descs), jnp.asarray(cents)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert set(got[[0, 2, 4]]) == {0, 1, 2}
