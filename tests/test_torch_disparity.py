"""Dense disparity (cost volume, winner-take-all, block matching, SGM, MI):
the port against the JAX package on the same numpy inputs, on the CPU.

Images are integer-valued, so census codes, Hamming costs and the SGM
recurrence on them are exact in float32 and compared bit for bit.  The SAD
volume's box filter runs float32 prefix sums past the 1e6 out-of-range
sentinel: a row's running sum reaches 1e8, where one ulp is 8, and the two
packages add in different orders.  So the SAD paths are compared exactly at a
size where every prefix sum stays below 2^24 (one window row, 16
disparities, 64 columns), and with a stated bound at the 7x7 window.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from boofcv_tpu.feature import disparity as jd
from boofcv_tpu_torch.feature import disparity as td

torch.set_num_threads(1)


def _pair(seed, h, w, dmax):
    """Integer-valued rectified pair of a band-limited texture whose true
    disparity grows with the row from 3 to dmax - 2 (whole pixels)."""
    rng = np.random.default_rng(seed)
    tex = rng.normal(0, 1, (h, w + dmax + 8))
    k = np.hanning(5)
    k /= k.sum()
    tex = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, tex)
    tex = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, tex)
    tex = np.round(128 + 60 * tex / tex.std()).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    disp = 3 + (dmax - 5) * yy // h
    return tex[:, :w].copy(), tex[yy, xx + disp].copy(), disp


def _cfgs(**kw):
    jc = jd.DisparityConfig(**kw)
    return jc, td.DisparityConfig(**jc._asdict())


def _sgm_cfgs(**kw):
    jc = jd.SgmConfig(**kw)
    return jc, td.SgmConfig(**jc._asdict())


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _maps_agree(ref, out, px):
    """The bar for disparity maps: valid masks agree on >= 99 % of
    the pixels and disparities within ``px`` on >= 99 % of those valid in
    both."""
    ref, out = np.asarray(ref), out.numpy()
    assert ref.shape == out.shape and out.dtype == np.float32
    va, vb = ref >= 0, out >= 0
    assert (va == vb).mean() >= 0.99
    both = va & vb
    assert both.mean() > 0.5
    assert (np.abs(ref - out)[both] <= px).mean() >= 0.99
    assert np.all(out[~vb] == td.INVALID)


def test_config_has_the_references_fields():
    assert td.DisparityConfig._fields == jd.DisparityConfig._fields
    assert td.DisparityConfig() == td.DisparityConfig(
        **jd.DisparityConfig()._asdict())
    assert td.SgmConfig._fields == jd.SgmConfig._fields
    assert td.SgmConfig() == td.SgmConfig(**jd.SgmConfig()._asdict())
    assert td.INVALID == jd.INVALID


# the one-row window keeps every prefix sum below 2^24: exact by construction
EXACT_SAD = dict(max_disparity=16, radius_x=3, radius_y=0)


@pytest.mark.parametrize("kw", [EXACT_SAD,
                                dict(EXACT_SAD, min_disparity=2,
                                     max_disparity=17)])
def test_cost_volume_sad_exact_by_construction(kw):
    left, right, _ = _pair(0, 48, 64, 16)
    jc, tc = _cfgs(**kw)
    ref = np.asarray(jd.cost_volume(*_j(left, right), jc))
    out = td.cost_volume(*_t(left, right), tc).numpy()
    assert float(ref.max()) < 2 ** 24
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kw", [dict(max_disparity=16),
                                dict(min_disparity=2, max_disparity=20)])
def test_cost_volume_sad_7x7(kw):
    """Exact where no sentinel is anywhere in the slice (d = 0 with
    min_disparity 0) and where no sentinel is in the window when the values
    are taken modulo the rounding of the prefix sums: elsewhere within 4 ulp
    of the largest running sum, 7e6 a sentinel column."""
    left, right, _ = _pair(1, 64, 96, kw["max_disparity"])
    jc, tc = _cfgs(**kw)
    ref = np.asarray(jd.cost_volume(*_j(left, right), jc))
    out = td.cost_volume(*_t(left, right), tc).numpy()
    if jc.min_disparity == 0:
        np.testing.assert_array_equal(out[0], ref[0])
    reach = jc.max_disparity - 1 + jc.radius_x
    bound = 4 * float(np.spacing(np.float32(7e6 * reach)))
    # no sentinel in the window: x - rx >= min + d
    d = jc.min_disparity + np.arange(ref.shape[0])[:, None, None]
    clear = np.broadcast_to(
        np.arange(96)[None, None, :] - jc.radius_x >= d, ref.shape)
    assert float(np.abs(out - ref)[clear].max()) <= bound
    assert float(ref[clear].max()) < 7 * 7 * 256


@pytest.mark.parametrize("kw", [
    dict(max_disparity=16, error="census"),
    dict(min_disparity=3, max_disparity=24, radius_x=0, radius_y=0,
         error="census"),
    dict(max_disparity=20, radius_x=2, radius_y=1, error="census")])
def test_cost_volume_census_exact(kw):
    left, right, _ = _pair(2, 48, 64, kw["max_disparity"])
    left[5:9, 10:30] = 77.0            # a uniform patch: census code 0
    jc, tc = _cfgs(**kw)
    ref = np.asarray(jd.cost_volume(*_j(left, right), jc))
    out = td.cost_volume(*_t(left, right), tc).numpy()
    np.testing.assert_array_equal(out, ref)


def test_separable_box_exact_on_integers():
    vol = np.random.default_rng(3).integers(0, 200, (5, 20, 30)).astype(
        np.float32)
    for ry, rx in ((0, 0), (1, 2), (3, 3)):
        ref = np.asarray(jd._separable_box(jnp.asarray(vol), ry, rx))
        out = td._separable_box(torch.from_numpy(vol), ry, rx).numpy()
        np.testing.assert_array_equal(out, ref)


def test_argmin_takes_the_first_of_equal_minima():
    """The winner, the left-right check and the subpixel step all read
    ``argmin``: with integer costs ties are common."""
    vol = np.random.default_rng(4).integers(0, 4, (12, 30, 40)).astype(
        np.float32)
    vol[3] = 0.0
    vol[7] = 0.0                        # two planes of equal minima
    first = np.argmin(vol, axis=0)
    assert np.array_equal(np.asarray(jnp.argmin(jnp.asarray(vol), axis=0)),
                          first)
    assert np.array_equal(torch.argmin(torch.from_numpy(vol), dim=0).numpy(),
                          first)
    assert np.array_equal(torch.min(torch.from_numpy(vol), dim=0)[1].numpy(),
                          first)


@pytest.mark.parametrize("kw", [
    dict(max_disparity=12),
    dict(min_disparity=2, max_disparity=14, texture_threshold=0.0),
    dict(max_disparity=12, validate_lr=-1, subpixel=False,
         max_per_pixel_error=0.05),
    dict(max_disparity=12, validate_lr=0, texture_threshold=0.5)])
def test_wta_select_gathers_equal_the_references_shifts(kw):
    """``_wta_select`` on a small-integer volume with planted ties: the
    port's gathers are the reference's pad-and-slice shifts and one-hot
    sums, so the maps are equal bit for bit (the parabola's three operands
    are the same floats)."""
    rng = np.random.default_rng(5)
    cost = rng.integers(0, 6, (12, 30, 40)).astype(np.float32)
    cost[:, 10:14, :] = 2.0             # rows where every disparity ties
    cost[4, 20:25, 5:35] = 0.0
    jc, tc = _cfgs(**kw)
    ref = np.asarray(jd._wta_select(jnp.asarray(cost), jc))
    out = td._wta_select(torch.from_numpy(cost), tc).numpy()
    assert (ref >= 0).mean() > 0.05
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", ["block_match", "block_match_best5"])
@pytest.mark.parametrize("kw", [
    EXACT_SAD,
    dict(max_disparity=16, error="census"),
    dict(min_disparity=2, max_disparity=18, error="census",
         texture_threshold=0.0)])
def test_block_match_exact_costs(name, kw):
    """Where the costs are exact in both packages (the one-row SAD window,
    census) the maps agree to 1e-3 px on >= 99 % of the pixels."""
    left, right, gt = _pair(6, 48, 64, 16)
    jc, tc = _cfgs(**kw)
    ref = getattr(jd, name)(*_j(left, right), jc)
    out = getattr(td, name)(*_t(left, right), tc)
    _maps_agree(ref, out, 1e-3)
    ok = out.numpy() >= 0
    assert np.median(np.abs(out.numpy() - gt)[ok]) < 0.5


@pytest.mark.parametrize("name", ["block_match", "block_match_best5"])
@pytest.mark.parametrize("h,w,kw", [
    (64, 96, dict(max_disparity=16)),
    (64, 96, dict(min_disparity=2, max_disparity=24))])
def test_block_match_sad_7x7(name, h, w, kw):
    """The 7x7 SAD window: the costs carry the prefix sums' rounding (8 to
    32 on costs of a few hundred, in either package), which moves the
    subpixel parabola by hundredths of a pixel.  Valid masks agree on >= 99
    %, disparities within 0.05 px on >= 99 %, and both packages are as
    close to the truth."""
    left, right, gt = _pair(7, h, w, kw["max_disparity"])
    jc, tc = _cfgs(**kw)
    ref = getattr(jd, name)(*_j(left, right), jc)
    out = getattr(td, name)(*_t(left, right), tc)
    _maps_agree(ref, out, 0.05)
    ref, out = np.asarray(ref), out.numpy()
    err = lambda d: float(np.median(np.abs(d - gt)[d >= 0]))
    assert err(out) < 0.5 and abs(err(out) - err(ref)) < 0.01


def test_sgm_scan_bit_equal():
    """One direction of the recurrence, on integer costs and on arbitrary
    floats: the same operations in the same order, so the same bits; two
    stacked scans equal two single ones."""
    rng = np.random.default_rng(8)
    for cost in (rng.integers(0, 25, (10, 12, 20)).astype(np.float32),
                 rng.uniform(0, 300, (10, 12, 20)).astype(np.float32)):
        ref = np.asarray(jd._sgm_scan(jnp.asarray(cost), 5.0, 60.0))
        out = td._sgm_scan(torch.from_numpy(cost), 5.0, 60.0)
        assert out.shape == cost.shape
        np.testing.assert_array_equal(out.numpy(), ref)
        flipped = np.ascontiguousarray(cost[:, :, ::-1])
        two = td._sgm_scan(torch.from_numpy(np.stack([cost, flipped])),
                           5.0, 60.0)
        np.testing.assert_array_equal(two[0].numpy(), ref)
        np.testing.assert_array_equal(
            two[1].numpy(),
            np.asarray(jd._sgm_scan(jnp.asarray(flipped), 5.0, 60.0)))


def _jax_aggregate4(cost, p1, p2):
    """The reference's four-path sum (``sgm``'s own lines)."""
    agg = jd._sgm_scan(cost, p1, p2)
    agg = agg + jnp.flip(jd._sgm_scan(jnp.flip(cost, 2), p1, p2), 2)
    ct = jnp.swapaxes(cost, 1, 2)
    agg = agg + jnp.swapaxes(jd._sgm_scan(ct, p1, p2), 1, 2)
    return agg + jnp.swapaxes(
        jnp.flip(jd._sgm_scan(jnp.flip(ct, 2), p1, p2), 2), 1, 2)


def test_sgm_census_aggregated_volume_bit_equal():
    left, right, _ = _pair(9, 48, 64, 16)
    jc, tc = _cfgs(max_disparity=16, radius_x=0, radius_y=0, error="census")
    jcost = jnp.minimum(jd.cost_volume(*_j(left, right), jc), 1e5)
    tcost = torch.clamp(td.cost_volume(*_t(left, right), tc), max=1e5)
    np.testing.assert_array_equal(tcost.numpy(), np.asarray(jcost))
    ref = np.asarray(_jax_aggregate4(jcost, 5.0, 60.0))
    out = td._aggregate(tcost, 5.0, 60.0, 4).numpy()
    assert float(ref.max()) < 2 ** 24 and np.all(ref == np.round(ref))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kw", [
    dict(max_disparity=16),
    dict(max_disparity=16, paths=8),
    dict(min_disparity=2, max_disparity=18, paths=8, validate_lr=0,
         texture_threshold=0.1)])
def test_sgm_census_exact(kw):
    """Census SGM is integer arithmetic in float32 up to the subpixel
    parabola, whose operands are equal: the maps are bit-equal."""
    left, right, gt = _pair(10, 48, 64, 16)
    jc, tc = _sgm_cfgs(**kw)
    ref = np.asarray(jd.sgm(*_j(left, right), jc))
    out = td.sgm(*_t(left, right), tc).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out >= 0).mean() > 0.6
    assert np.median(np.abs(out - gt)[out >= 0]) < 0.5


@pytest.mark.parametrize("kw", [dict(max_disparity=16, error="sad"),
                                dict(max_disparity=16, error="sad", paths=8)])
def test_sgm_sad(kw):
    left, right, _ = _pair(11, 48, 64, 16)
    jc, tc = _sgm_cfgs(**kw)
    _maps_agree(jd.sgm(*_j(left, right), jc), td.sgm(*_t(left, right), tc),
                1e-3)


def test_mi_cost_table_and_volume():
    """The table to 1e-5 of its largest entry (two Gaussian blurs and a
    log); the volume is a lookup, exact given the same table."""
    left, right, gt = _pair(12, 48, 64, 16)
    prior = gt.astype(np.float32)
    prior[::5, ::3] = -1.0
    ref = np.asarray(jd.mi_cost_table(*_j(left, right, prior), bins=32))
    out = td.mi_cost_table(*_t(left, right, prior), bins=32)
    assert out.shape == (32, 32) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * float(ref.max()))
    jc, tc = _sgm_cfgs(min_disparity=1, max_disparity=17)
    vref = np.asarray(jd._mi_cost_volume(*_j(left, right, ref), jc, 32))
    vout = td._mi_cost_volume(*_t(left, right, ref), tc, 32).numpy()
    np.testing.assert_array_equal(vout, vref)


def test_sgm_hmi():
    left, right, gt = _pair(13, 47, 63, 10)      # odd sizes: cropped levels
    jc, tc = _sgm_cfgs(max_disparity=10)
    ref = jd.sgm_hmi(*_j(left, right), jc, levels=2, bins=32)
    out = td.sgm_hmi(*_t(left, right), tc, levels=2, bins=32)
    _maps_agree(ref, out, 1e-3)
    ok = out.numpy() >= 0
    assert np.median(np.abs(out.numpy() - gt)[ok]) < 1.0


def test_sparse_block_match_reads_the_widened_config():
    """The per-pixel error bound and the subpixel switch, which the dense
    matchers brought into the config, hold for the sparse matcher too."""
    left, right, _ = _pair(14, 48, 64, 16)
    rng = np.random.default_rng(14)
    ys = rng.integers(0, 48, 120).astype(np.int32)
    xs = rng.integers(0, 64, 120).astype(np.int32)
    for kw in (dict(max_disparity=16, max_per_pixel_error=3.0,
                    subpixel=False),
               dict(max_disparity=16, max_per_pixel_error=1.0)):
        jc, tc = _cfgs(**kw)
        rd, rv = jd.sparse_block_match(*_j(left, right, ys, xs), jc)
        od, ov = td.sparse_block_match(*_t(left, right, ys, xs), tc)
        assert np.array_equal(ov.numpy(), np.asarray(rv))
        assert 0 < int(ov.sum()) < 120
        np.testing.assert_allclose(od.numpy()[ov.numpy()],
                                   np.asarray(rd)[ov.numpy()], atol=1e-4)


def _sparse_points(seed, h, w, n):
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, h, n).astype(np.int32)
    xs = rng.integers(0, w, n).astype(np.int32)
    ys[:4] = [0, 1, h - 1, h - 2]                     # rows past the image
    xs[:4] = [0, 3, w - 1, 20]
    return ys, xs


def test_sparse_ssd_costs():
    """SSD costs against the reference's ``_sparse_costs_ssd``.  The
    reference expands |L - R|^2 as |L|^2 + |R|^2 - 2<L, R> in float32, the
    port sums the squares: they agree to 1e-5 of |L|^2 + |R|^2 (the
    expansion's rounding scale), 1e18 where the window leaves the image in
    both; the winners are equal wherever the reference's second best is
    more than 1e-3 (relative) above its best."""
    left, right, _ = _pair(15, 40, 72, 20)
    ys, xs = _sparse_points(15, 40, 72, 150)
    jc, tc = _cfgs(max_disparity=20, radius_x=3, radius_y=2, error="ssd")
    ref = np.asarray(jd._sparse_costs_ssd(*_j(left, right, ys, xs), jc))
    tl, tr, tys, txs = _t(left, right, ys, xs)
    out = td._sparse_costs_ssd(tl, tr, tys, txs, tc).numpy()
    patch, win, inb = td._sparse_windows(tl, tr, tys, txs, tc)
    energy = (np.sum(patch.numpy().astype(np.float64) ** 2, axis=(-2, -1))
              [:, None] + np.sum(win.numpy().astype(np.float64) ** 2,
                                 axis=(-3, -1)))          # [N, D]
    far = out >= 1e18
    np.testing.assert_array_equal(far, ref >= 1e18)
    assert 0 < far.sum() < far.size
    np.testing.assert_array_less(np.abs(out - ref)[~far],
                                 1e-5 * energy[~far] + 1e-3)
    srt = np.sort(ref, axis=1)
    margin = (srt[:, 1] - srt[:, 0]) / np.maximum(srt[:, 0], 1e-6)
    sure = (margin > 1e-3) & (srt[:, 0] < 1e17)
    assert sure.mean() > 0.8
    np.testing.assert_array_equal(out.argmin(1)[sure], ref.argmin(1)[sure])


@pytest.mark.parametrize("bound", [-1.0, 35.0])
def test_sparse_block_match_ssd(bound):
    """``error="ssd"`` end to end, the per-pixel bound squared as in the
    reference: ``valid`` equal and disparities within 1e-3 px where the
    reference's winner is sure (as above)."""
    left, right, _ = _pair(16, 40, 72, 20)
    ys, xs = _sparse_points(16, 40, 72, 150)
    jc, tc = _cfgs(max_disparity=20, radius_x=3, radius_y=2, error="ssd",
                   max_per_pixel_error=bound, texture_threshold=0.05)
    rd, rv = jd.sparse_block_match(*_j(left, right, ys, xs), jc)
    od, ov = td.sparse_block_match(*_t(left, right, ys, xs), tc)
    costs = np.asarray(jd._sparse_costs_ssd(*_j(left, right, ys, xs), jc))
    srt = np.sort(costs, axis=1)
    sure = (srt[:, 1] - srt[:, 0]) > 1e-3 * np.maximum(srt[:, 0], 1e-6)
    np.testing.assert_array_equal(ov.numpy()[sure], np.asarray(rv)[sure])
    both = sure & ov.numpy()
    assert both.sum() > 40
    np.testing.assert_allclose(od.numpy()[both], np.asarray(rd)[both],
                               atol=1e-3)
    if bound > 0:          # the squared bound rejects some, not all
        unbounded = tc._replace(max_per_pixel_error=-1.0)
        assert 0 < int(ov.sum()) < int(td.sparse_block_match(
            *_t(left, right, ys, xs), unbounded)[1].sum())


def test_sparse_block_match_error_names():
    """"sad" and "sad_xla" are the one SAD; anything else raises."""
    left, right, _ = _pair(17, 24, 48, 12)
    ys, xs = _sparse_points(17, 24, 48, 30)
    args = _t(left, right, ys, xs)
    a = td.sparse_block_match(*args, td.DisparityConfig(max_disparity=12))
    b = td.sparse_block_match(*args, td.DisparityConfig(max_disparity=12,
                                                        error="sad_xla"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        td.sparse_block_match(*args, td.DisparityConfig(max_disparity=12,
                                                        error="census"))


def test_sparse_ssd_streams():
    """Two streams in one call: each equal, bit for bit, to its own call."""
    pairs = [_pair(18 + b, 32, 64, 16) for b in range(2)]
    pts = [_sparse_points(18 + b, 32, 64, 60) for b in range(2)]
    cfg = td.DisparityConfig(max_disparity=16, error="ssd")
    L, R = (torch.from_numpy(np.stack([p[i] for p in pairs])) for i in (0, 1))
    Y, X = (torch.from_numpy(np.stack([p[i] for p in pts])) for i in (0, 1))
    d2, v2 = td.sparse_block_match(L, R, Y, X, cfg)
    for b in range(2):
        d1, v1 = td.sparse_block_match(L[b], R[b], Y[b], X[b], cfg)
        assert torch.equal(d1, d2[b]) and torch.equal(v1, v2[b])
