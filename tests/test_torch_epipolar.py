"""Small linear algebra, epipolar geometry, robust F/E/H and Finsterwalder's
P3P: the port against the JAX package on the same seeded numpy inputs.

Tolerances: float64 results agree to 1e-9 relative to the largest entry,
F, E and H up to sign (and scale where the reference leaves it free);
eigenvector pairs as subspaces; solution sets (7-point, Nister) as sets.
Index sets are the reference's own draws, injected into the port.  The
float32 P3P is held at 1e-4 on well-conditioned samples, as Grunert is."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.geo import epipolar as jep
from boofcv_tpu.geo import pnp as jpnp
from boofcv_tpu.geo import robust as jrobust
from boofcv_tpu.geo import se3 as jse3
from boofcv_tpu.geo import smalllinalg as jla
from boofcv_tpu_torch.geo import epipolar as tep
from boofcv_tpu_torch.geo import pnp as tpnp
from boofcv_tpu_torch.geo import robust as trobust
from boofcv_tpu_torch.geo import smalllinalg as tla

torch.set_num_threads(1)
RTOL = 1e-9


def T(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ref, out, rtol=RTOL):
    ref, out = np.asarray(ref), _np(out)
    assert ref.shape == out.shape
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * scale)


def _up_to_sign(ref, out, rtol=RTOL):
    """[..., 3, 3] matrices equal up to a sign per matrix (scales equal)."""
    ref, out = np.asarray(ref), _np(out)
    dot = np.sum(ref * out, axis=(-2, -1), keepdims=True)
    _close(ref, out * np.where(dot < 0, -1.0, 1.0), rtol)


def _unit(m):
    m = m / np.linalg.norm(m, axis=(-2, -1), keepdims=True)
    flat = m.reshape(m.shape[:-2] + (9,))
    i = np.argmax(np.abs(flat), axis=-1)[..., None]
    return m * np.sign(np.take_along_axis(flat, i, -1))[..., None]


def _same_sets(ref, ref_ok, out, out_ok, rtol=1e-7, share=1.0):
    """Per sample, the valid matrices as sets up to sign and scale; on at
    least ``share`` of the samples the two sets have the same size, and
    those are compared."""
    ref, out = _unit(np.asarray(ref)), _unit(_np(out))
    ref_ok, out_ok = np.asarray(ref_ok), _np(out_ok)
    same = ref_ok.sum(-1) == out_ok.sum(-1)
    assert same.mean() >= share, (ref_ok.sum(-1), out_ok.sum(-1))
    for k in np.flatnonzero(same):
        a, b = ref[k][ref_ok[k]], out[k][out_ok[k]]
        d = np.abs(a[:, None] - b[None]).max(axis=(-2, -1))
        assert (d.min(axis=1) <= rtol).all(), (k, d)


def _two_view(rng, n=60, outliers=0.0, planar=False, noise=0.0):
    """Points seen by two cameras (K, R, t): pixels p1, p2, normalized
    n1, n2, and the true E, F."""
    K = np.array([[500.0, 0, 320], [0, 490.0, 240], [0, 0, 1]])
    depth = 4.0 + (np.zeros(n) if planar else rng.uniform(0, 4, n))
    X = np.c_[rng.uniform(-2, 2, (n, 2)), depth]
    w = rng.normal(0, 0.08, 3)
    th = np.linalg.norm(w)
    kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
    t = np.array([0.6, 0.05, 0.1])
    X2 = X @ R.T + t
    n1 = X[:, :2] / X[:, 2:]
    n2 = X2[:, :2] / X2[:, 2:]
    n2 = n2 + rng.normal(0, noise, n2.shape)
    bad = rng.uniform(size=n) < outliers
    n2[bad] = rng.uniform(-0.6, 0.6, (int(bad.sum()), 2))
    pix = lambda q: q @ K[:2, :2].T + K[:2, 2]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    F = np.linalg.inv(K).T @ E @ np.linalg.inv(K)
    return pix(n1), pix(n2), n1, n2, K, E, F, bad


# ---------------------------------------------------------------------------
# smalllinalg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["det2", "inv2", "solve33", "solve_spd",
                                  "inv_spd"])
def test_small_linalg(name):
    rng = np.random.default_rng(1)
    n = 3 if name == "solve33" else (2 if name in ("det2", "inv2") else 5)
    A = rng.normal(0, 1, (16, n, n))
    if name in ("solve_spd", "inv_spd"):
        A = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(n)
        A = A + 1e-12 * rng.normal(0, 1, A.shape)     # not exactly symmetric
    b = rng.normal(0, 1, (16, n))
    args = (A, b) if name in ("solve33", "solve_spd") else (A,)
    ref = getattr(jla, name)(*(jnp.asarray(a) for a in args))
    out = getattr(tla, name)(*(T(a) for a in args))
    _close(ref, out)


def test_poly_roots():
    """Durand-Kerner from the same start circle with the same arithmetic:
    every root, real and complex, to 1e-9 in the same order."""
    rng = np.random.default_rng(2)
    roots = rng.uniform(-3, 3, (8, 10))
    coeffs = np.stack([np.poly(r) for r in roots]) * rng.uniform(
        0.5, 2, (8, 1))
    coeffs[:3] = rng.normal(0, 1, (3, 11))            # complex pairs too
    zr_j, zi_j = jla.poly_roots(jnp.asarray(coeffs))
    zr_t, zi_t = tla.poly_roots(T(coeffs))
    _close(zr_j, zr_t)
    _close(zi_j, zi_t)
    got = np.sort(_np(zr_t)[3:], axis=-1)
    np.testing.assert_allclose(got, np.sort(roots[3:], axis=-1), atol=1e-8)


# ---------------------------------------------------------------------------
# epipolar
# ---------------------------------------------------------------------------

def test_normalize_design_nullspace():
    rng = np.random.default_rng(3)
    p1, p2 = rng.uniform(0, 640, (2, 5, 7, 2))
    for r, o in zip(jep.normalize_points(jnp.asarray(p1)),
                    tep.normalize_points(T(p1))):
        _close(r, o)
    A = np.asarray(jep._epipolar_design(jnp.asarray(p1), jnp.asarray(p2)))
    _close(A, tep._epipolar_design(T(p1), T(p2)))
    # the two least right singular vectors, compared as a subspace
    proj = lambda a, b: (np.einsum("...i,...j->...ij", a, a)
                         + np.einsum("...i,...j->...ij", b, b))
    ref = proj(*(np.asarray(v) for v in jep._nullspace2(jnp.asarray(A))))
    out = proj(*(_np(v) for v in tep._nullspace2(T(A))))
    _close(ref, out, 1e-8)
    A9 = rng.normal(0, 1, (5, 9, 9))
    A9[..., 8, :] = A9[..., :8, :].sum(-2)          # a one-dim nullspace
    v_ref = np.asarray(jep._smallest_singular_vector(jnp.asarray(A9)))
    v_out = _np(tep._smallest_singular_vector(T(A9)))
    _close(v_ref, v_out * np.sign(np.sum(v_ref * v_out, -1))[..., None],
           1e-8)


@pytest.mark.parametrize("fn", ["fundamental_8pt", "essential_8pt",
                                "fundamental_8pt_weighted"])
def test_linear_solvers(fn):
    rng = np.random.default_rng(4)
    p1, p2, n1, n2, K, E, F, _ = _two_view(rng, 40, noise=1e-3)
    a1, a2 = (n1, n2) if fn == "essential_8pt" else (p1, p2)
    kw_j, kw_t = {}, {}
    if fn.endswith("weighted"):
        wgt = rng.uniform(size=40) > 0.3
        kw_j, kw_t = dict(weights=jnp.asarray(wgt)), dict(weights=T(wgt))
    name = fn.replace("_weighted", "")
    ref = getattr(jep, name)(jnp.asarray(a1), jnp.asarray(a2), **kw_j)
    out = getattr(tep, name)(T(a1), T(a2), **kw_t)
    _up_to_sign(ref, out, 1e-8)


def test_fundamental_7pt_sets():
    rng = np.random.default_rng(5)
    samples = [_two_view(np.random.default_rng(s), 7)[:2] for s in range(12)]
    p1 = np.stack([s[0] for s in samples])
    p2 = np.stack([s[1] for s in samples])
    Fj, rj = jep.fundamental_7pt(jnp.asarray(p1), jnp.asarray(p2))
    Ft, rt = tep.fundamental_7pt(T(p1), T(p2))
    _same_sets(Fj, rj, Ft, rt)
    assert float(np.abs(np.linalg.det(_np(Ft)[_np(rt)])).max()) < 1e-8
    del rng


def test_residuals_and_conversions():
    rng = np.random.default_rng(6)
    p1, p2, n1, n2, K, E, F, _ = _two_view(rng, 50, noise=2e-3)
    Fs = np.stack([F, F * 2 + 1e-3, np.eye(3)])
    for name in ("sampson_error", "epipolar_constraint",
                 "homography_transfer_error"):
        _close(getattr(jep, name)(jnp.asarray(Fs)[:, None], jnp.asarray(p1),
                                  jnp.asarray(p2)),
               getattr(tep, name)(T(Fs)[:, None], T(p1), T(p2)))
    K2 = K * np.array([[1.1], [0.9], [1.0]])
    _close(jep.essential_from_fundamental(jnp.asarray(F), jnp.asarray(K),
                                          jnp.asarray(K2)),
           tep.essential_from_fundamental(T(F), T(K), T(K2)))
    _close(jep.fundamental_from_essential(jnp.asarray(E), jnp.asarray(K),
                                          jnp.asarray(K2)),
           tep.fundamental_from_essential(T(E), T(K), T(K2)))


def test_homography_dlt():
    rng = np.random.default_rng(7)
    p1, p2, *_ = _two_view(rng, 30, planar=True, noise=1e-4)
    batch1 = np.stack([p1[:4], p1[4:8], p1[8:12]])
    batch2 = np.stack([p2[:4], p2[4:8], p2[8:12]])
    _close(jep.homography_dlt(jnp.asarray(batch1), jnp.asarray(batch2)),
           tep.homography_dlt(T(batch1), T(batch2)), 1e-8)
    _close(jep.homography_dlt(jnp.asarray(p1), jnp.asarray(p2)),
           tep.homography_dlt(T(p1), T(p2)), 1e-8)


def test_decompose_and_cheirality():
    rng = np.random.default_rng(8)
    _, _, n1, n2, _, E, _, _ = _two_view(rng, 40)
    Rj, tj = jep.decompose_essential(jnp.asarray(E))
    Rt, tt = tep.decompose_essential(T(E))
    # the four candidates as a set of (R, t)
    key = lambda R, t: np.concatenate([np.asarray(R).reshape(4, 9),
                                       np.asarray(t)], 1)
    a, b = key(Rj, tj), key(_np(Rt), _np(tt))
    d = np.abs(a[:, None] - b[None]).max(-1)
    assert (d.min(1) <= 1e-9).all()
    Rb_j, tb_j, _ = jep.select_pose_cheirality(Rj, tj, jnp.asarray(n1),
                                               jnp.asarray(n2))
    Rb_t, tb_t, best = tep.select_pose_cheirality(Rt, tt, T(n1), T(n2))
    _close(Rb_j, Rb_t)
    _close(tb_j, tb_t)
    # batched candidates pick per batch element, on the device
    R2 = torch.stack([Rt, Rt.flip(0)])
    t2 = torch.stack([tt, tt.flip(0)])
    Rb2, tb2, best2 = tep.select_pose_cheirality(R2, t2, T(n1), T(n2))
    assert best2.shape == (2,) and int(best2[1]) == 3 - int(best)
    _close(Rb_j, Rb2[1])


def test_cameras_from_fundamental():
    rng = np.random.default_rng(9)
    *_, F, _ = _two_view(rng, 10)
    for r, o in zip(jep.cameras_from_fundamental(jnp.asarray(F)),
                    tep.cameras_from_fundamental(T(F))):
        r, o = np.asarray(r), _np(o)
        _close(r, o * np.sign(np.sum(r * o)))
    for r, o in zip(jep.epipoles_from_fundamental(jnp.asarray(F)),
                    tep.epipoles_from_fundamental(T(F))):
        r, o = np.asarray(r), _np(o)
        _close(r, o * np.sign(np.sum(r * o)))


def test_polymul():
    rng = np.random.default_rng(10)
    a, b = rng.normal(0, 1, (2, 6, 4)), rng.normal(0, 1, (6, 5))
    _close(jep._polymul(jnp.asarray(a), jnp.asarray(b)),
           tep._polymul(T(a), T(b)))
    np.testing.assert_allclose(_np(tep._N5_VINV), jep._N5_VINV, rtol=0,
                               atol=0)


def test_essential_nister5_sets():
    """Solution sets up to sign, sample by sample.  The 4-dim nullspace's
    basis is whatever orthonormal basis each library's eigh returns, so the
    degree-10 polynomial differs between the two, and its 120 fixed
    Durand-Kerner iterations (from a Cauchy-bound circle) converge on
    slightly different samples: sets of the same size (at least 80 % of the
    samples) agree to 1e-4 (a root still converging after 120 iterations
    differs by up to 3e-5 between the two), the true E is among the port's
    solutions to 1e-6 on at least 80 %."""
    samples = [_two_view(np.random.default_rng(100 + s), 5)
               for s in range(20)]
    n1 = np.stack([s[2] for s in samples])
    n2 = np.stack([s[3] for s in samples])
    Ej, vj = jep.essential_nister5(jnp.asarray(n1), jnp.asarray(n2))
    Et, vt = tep.essential_nister5(T(n1), T(n2))
    assert bool(torch.isnan(Et[~vt]).all())
    _same_sets(Ej, vj, Et, vt, 1e-4, share=0.8)
    found = [np.abs(_unit(_np(Et)[k][_np(vt)[k]]) - _unit(s[5])).max(
        axis=(-2, -1)).min(initial=9) < 1e-6 for k, s in enumerate(samples)]
    assert np.mean(found) >= 0.8, found


# ---------------------------------------------------------------------------
# robust estimators (the reference's index sets injected)
# ---------------------------------------------------------------------------

def _idx(seed, K, S, n, valid):
    return np.asarray(jrobust.sample_indices(jax.random.PRNGKey(seed), K, S,
                                             n, jnp.asarray(valid)))


@pytest.mark.parametrize("which", ["fundamental", "essential_nister5",
                                   "essential_8pt", "homography"])
def test_robust_with_injected_samples(which):
    rng = np.random.default_rng(11)
    planar = which == "homography"
    p1, p2, n1, n2, *_, bad = _two_view(rng, 120, outliers=0.3,
                                        planar=planar, noise=2e-4)
    valid = rng.uniform(size=120) > 0.05
    K = 96
    key = jax.random.PRNGKey(3)
    V = jnp.asarray(valid)
    if which == "fundamental":
        idx = _idx(3, K, 7, 120, valid)
        rj = jrobust.ransac_fundamental(key, jnp.asarray(p1), jnp.asarray(p2),
                                        num_hypotheses=K, valid_mask=V)
        rt = trobust.ransac_fundamental(None, T(p1), T(p2), num_hypotheses=K,
                                        valid_mask=T(valid), idx=T(idx))
        mj, mt = rj.model[0], rt.model[0]
    elif which == "homography":
        idx = _idx(3, K, 4, 120, valid)
        rj = jrobust.ransac_homography(key, jnp.asarray(p1), jnp.asarray(p2),
                                       num_hypotheses=K, valid_mask=V)
        rt = trobust.ransac_homography(None, T(p1), T(p2), num_hypotheses=K,
                                       valid_mask=T(valid), idx=T(idx))
        mj, mt = rj.model, rt.model
    else:
        name = which.split("_")[1]
        idx = _idx(3, K, 5 if name == "nister5" else 8, 120, valid)
        thr = 1e-5                      # about 1.5 px at f = 500
        rj = jrobust.ransac_essential(key, jnp.asarray(n1), jnp.asarray(n2),
                                      num_hypotheses=K, valid_mask=V,
                                      inlier_threshold=thr, solver_name=name)
        rt = trobust.ransac_essential(None, T(n1), T(n2), num_hypotheses=K,
                                      valid_mask=T(valid), inlier_threshold=thr,
                                      solver_name=name, idx=T(idx))
        mj, mt = rj.model, rt.model
    assert np.array_equal(_np(rt.inliers), np.asarray(rj.inliers))
    assert int(rt.num_inliers) == int(rj.num_inliers)
    _up_to_sign(mj, mt, 1e-6)
    np.testing.assert_allclose(float(rt.best_error), float(rj.best_error),
                               rtol=1e-6, atol=1e-12)
    # most true inliers kept, few outliers
    kept = _np(rt.inliers)
    assert kept[~bad & valid].mean() > 0.9 and kept[bad].mean() < 0.05


def test_least_median_of_squares():
    rng = np.random.default_rng(12)
    p1, p2, *_ = _two_view(rng, 90, outliers=0.3, planar=True, noise=2e-4)
    valid = rng.uniform(size=90) > 0.1
    K = 64
    idx = _idx(5, K, 4, 90, valid)

    def jsolver(s):
        return jep.homography_dlt(*s)

    def jscorer(H, pts):
        return jep.homography_transfer_error(H, *pts)

    rj = jrobust.least_median_of_squares(
        jax.random.PRNGKey(5), (jnp.asarray(p1), jnp.asarray(p2)), jsolver,
        jscorer, 4, K, valid_mask=jnp.asarray(valid))
    rt = trobust.least_median_of_squares(
        None, (T(p1), T(p2)), lambda s: (tep.homography_dlt(*s),),
        lambda m, pts: tep.homography_transfer_error(
            m[0], pts[0][..., None, :, :], pts[1][..., None, :, :]),
        4, K, valid_mask=T(valid), idx=T(idx))
    _close(rj.model, rt.model[0], 1e-8)
    assert np.array_equal(_np(rt.inliers), np.asarray(rj.inliers))
    np.testing.assert_allclose(float(rt.best_error), float(rj.best_error),
                               rtol=1e-8)


def test_robust_streams_are_independent():
    """Two streams in one call: each picks what its single-stream call
    picks (every reduction carries the stream axis)."""
    pairs = [_two_view(np.random.default_rng(20 + b), 80, outliers=0.2,
                       noise=1e-4) for b in range(2)]
    n1 = np.stack([p[2] for p in pairs])
    n2 = np.stack([p[3] for p in pairs])
    g = torch.Generator().manual_seed(0)
    idx = torch.stack([trobust.sample_indices(g, 48, 5, 80)
                       for _ in range(2)])
    both = trobust.ransac_essential(None, T(n1), T(n2), num_hypotheses=48,
                                    idx=idx)
    for b in range(2):
        one = trobust.ransac_essential(None, T(n1[b]), T(n2[b]),
                                       num_hypotheses=48, idx=idx[b])
        assert torch.equal(both.inliers[b], one.inliers)
        _close(_np(one.model), both.model[b], 1e-12)


# ---------------------------------------------------------------------------
# Finsterwalder's P3P and ransac_pnp(p3p=)
# ---------------------------------------------------------------------------

def _p3p_samples(rng, k):
    w = rng.uniform(-1, 1, (k, 3, 3)) + np.array([0, 0, 6.0])
    ang = rng.normal(0, 0.1, (k, 3))
    R = np.asarray(jse3.exp_so3(jnp.asarray(ang)))
    t = rng.normal(0, 0.3, (k, 3))
    Xc = np.einsum("kij,knj->kni", R, w) + t[:, None]
    return w, Xc[..., :2] / Xc[..., 2:], R, t


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_p3p_finsterwalder(dtype):
    """The port against the reference on the same samples; in float32 only
    on samples whose reference f32 solution is within 1e-5 of its f64 one
    (near double roots both packages miss the root by up to 1e-2)."""
    rng = np.random.default_rng(13)
    w, o, R, t = _p3p_samples(rng, 64)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    Rj, tj, okj = jpnp.p3p_finsterwalder(jnp.asarray(w), jnp.asarray(o),
                                         dtype=jd)
    Rt, tt, okt = tpnp.p3p_finsterwalder(T(w), T(o), dtype=td)
    assert Rt.dtype == td
    okj, okt = np.asarray(okj), _np(okt)
    if dtype == "float64":
        assert np.array_equal(okj, okt)
        ok = okj
        tol = 1e-6       # the final alignment runs in float32 in both
    else:
        R64, _, ok64 = jpnp.p3p_finsterwalder(jnp.asarray(w), jnp.asarray(o))
        good = (np.abs(np.asarray(Rj) - np.asarray(R64)).max((-2, -1))
                < 1e-5) & ok64
        ok = okj & okt & good
        assert ok.sum() > 0.5 * ok64.sum()
        tol = 1e-4
    np.testing.assert_allclose(_np(Rt)[ok], np.asarray(Rj)[ok], atol=tol)
    np.testing.assert_allclose(_np(tt)[ok], np.asarray(tj)[ok], atol=tol)
    # and the true pose is among the valid solutions of most samples
    err = np.abs(_np(Rt) - R[:, None]).max((-2, -1))
    assert (np.where(okt, err, 9).min(1) < 1e-3).mean() > 0.9


def test_ransac_pnp_finsterwalder_with_injected_samples():
    rng = np.random.default_rng(14)
    w = rng.uniform(-2, 2, (150, 3)) + np.array([0, 0, 8.0])
    R = np.eye(3)
    t = np.array([0.1, -0.05, 0.2])
    Xc = w @ R.T + t
    obs = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 3e-4, (150, 2))
    obs[:30] = rng.uniform(-0.3, 0.3, (30, 2))
    K = 96
    thr = (1.5 / 480.0) ** 2
    key = jax.random.PRNGKey(14)
    idx = np.asarray(jrobust.sample_indices(key, K, 3, 150))
    rj, (Rj, tj) = jrobust.ransac_pnp(key, jnp.asarray(w), jnp.asarray(obs),
                                      num_hypotheses=K, inlier_threshold=thr,
                                      p3p="finsterwalder")
    rt, (Rt, tt) = trobust.ransac_pnp(None, T(w), T(obs), num_hypotheses=K,
                                      inlier_threshold=thr,
                                      p3p="finsterwalder", idx=T(idx))
    assert np.array_equal(_np(rt.inliers), np.asarray(rj.inliers))
    np.testing.assert_allclose(_np(Rt), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(_np(tt), np.asarray(tj), atol=1e-6)
    with pytest.raises(ValueError):
        trobust.ransac_pnp(None, T(w), T(obs), p3p="nope", idx=T(idx))
