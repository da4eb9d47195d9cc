"""The port's bundle adjustment (``boofcv_tpu_torch/geo/ba.py``) against the
JAX package on the CPU: one seeded numpy scene goes through both, function
by function and through ``optimize`` as a whole.

Tolerances, unless a test states another: the largest absolute difference
is at most 1e-10 (float64) or 1e-5 (float32) of the largest entry of the
reference's result.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boofcv_tpu.geo import ba as jba
from boofcv_tpu.geo import se3 as jse3
from boofcv_tpu.geo import smalllinalg as jsl
from boofcv_tpu_torch.geo import ba as tba
from boofcv_tpu_torch.geo import se3 as tse3
from boofcv_tpu_torch.geo import smalllinalg as tsl

MODELS = ("normalized", "snavely", "pinhole_f")
DTYPES = ("float64", "float32")
NOISE = 5e-4


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * (k @ k)


def _np_project(model, Xc, intr):
    if model == "normalized":
        return Xc[:2] / Xc[2]
    if model == "pinhole_f":
        return intr[0] * Xc[:2] / Xc[2]
    p = -Xc[:2] / Xc[2]
    r2 = p @ p
    return intr[0] * (1 + intr[1] * r2 + intr[2] * r2 * r2) * p


def scene(seed, model="normalized", V=6, P=48, L=5, noise=NOISE,
          perturb=True):
    """A seeded scene as the dict ``problem_from_numpy`` takes (float64):
    3 to L observations a point in sorted views, the other slots invalid
    (view 0, pixel 0), views 0 and 1 fixed, the initial guess perturbed."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, P), rng.uniform(-2, 2, P),
                    rng.uniform(4, 8, P)], 1)
    Rs = np.stack([_rodrigues(rng.normal(0, 0.03, 3)) for _ in range(V)])
    ts = np.stack([np.array([0.4 * v - 1.0, 0.05 * v, 0.02 * v])
                   for v in range(V)])
    scale = 1.0
    if model == "snavely":
        intr = np.tile([500.0, 0.02, 0.004], (V, 1))
        pts = pts * np.array([1.0, 1.0, -1.0])     # looks down -z
        scale = 500.0
    elif model == "pinhole_f":
        intr = np.full((V, 1), 450.0)
        scale = 450.0
    else:
        intr = np.zeros((V, 0))
    obs_xy = np.zeros((P, L, 2))
    obs_view = np.zeros((P, L), np.int32)
    obs_valid = np.zeros((P, L), bool)
    for p in range(P):
        views = rng.permutation(V)[:rng.integers(3, L + 1)]
        for s, v in enumerate(sorted(views)):
            Xc = Rs[v] @ pts[p] + ts[v]
            obs_xy[p, s] = (_np_project(model, Xc, intr[v])
                            + rng.normal(0, noise * scale, 2))
            obs_view[p, s] = v
            obs_valid[p, s] = True
    fixed = np.zeros(V, bool)
    fixed[:2] = True
    if perturb:
        for v in range(2, V):
            Rs[v] = _rodrigues(rng.normal(0, 0.005, 3)) @ Rs[v]
            ts[v] = ts[v] + rng.normal(0, 0.01, 3)
        pts = pts + rng.normal(0, 0.02, pts.shape)
        if model != "normalized":
            intr = intr + np.array([[2.0, 0.0, 0.0]])[:, :intr.shape[1]]
    return {"R": Rs, "t": ts, "intr": intr, "points": pts, "obs_xy": obs_xy,
            "obs_view": obs_view, "obs_valid": obs_valid,
            "fixed_views": fixed, "model": model}


def both(d, dtype="float64"):
    """The scene as the JAX package's problem and as the port's."""
    d = {k: (v.astype(dtype) if isinstance(v, np.ndarray)
             and v.dtype == np.float64 else v) for k, v in d.items()}
    jp = jba.BAProblem(*(jnp.asarray(d[k]) for k in jba.BAProblem._fields
                         if k != "model"), d["model"])
    return jp, tba.problem_from_numpy(d, device="cpu")


def T(a):
    """A JAX array as a CPU tensor."""
    return torch.from_numpy(np.array(a))


def close(got, want, dtype, tol=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert str(got.dtype) == str(want.dtype), (got.dtype, want.dtype)
    if want.size == 0:
        return
    tol = tol or {"float64": 1e-10, "float32": 1e-5}[dtype]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def test_det3_inv3_match_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(5, 4, 3, 3))
    for dtype in DTYPES:
        a = A.astype(dtype)
        close(tsl.det3(T(a)), jsl.det3(jnp.asarray(a)), dtype)
        close(tsl.inv3(T(a)), jsl.inv3(jnp.asarray(a)), dtype, tol=1e-4
              if dtype == "float32" else 1e-9)


def test_inv3_near_singular_block():
    """The 1e-300 determinant guard is live in float64 (a zero determinant
    is replaced, the result is finite) and rounds to 0 in float32 (a
    singular block divides by zero): the port does what the reference does
    in each dtype."""
    A = np.stack([np.diag([1.0, 1.0, 0.0]),            # singular
                  np.diag([1e-101, 1e-100, 1e-100]),    # det 1e-301
                  np.diag([1.0, 2.0, 4.0]) + 1e-3])
    for dtype in DTYPES:
        got = tsl.inv3(T(A.astype(dtype))).numpy()
        want = np.asarray(jsl.inv3(jnp.asarray(A.astype(dtype))))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    assert np.isfinite(tsl.inv3(T(A)).numpy()).all()
    assert not np.isfinite(tsl.inv3(T(A.astype("float32"))).numpy()[0]).all()


def test_se3_additions_match_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.5, (7, 3))
    R = np.asarray(jse3.exp_so3(jnp.asarray(w)))
    t = rng.normal(size=(7, 3))
    pts = rng.normal(size=(7, 11, 3))
    close(tse3.transform(T(R), T(t), T(pts)),
          jse3.transform(jnp.asarray(R), jnp.asarray(t), jnp.asarray(pts)),
          "float64")
    close(tse3.rotation_angle(T(R)), jse3.rotation_angle(jnp.asarray(R)),
          "float64")
    M = R + rng.normal(0, 0.05, R.shape)
    close(tse3.project_to_so3(T(M)), jse3.project_to_so3(jnp.asarray(M)),
          "float64")
    # the leading axis that the reference reaches through vmap
    xi = rng.normal(0, 0.2, (7, 6))
    dR, dt = tse3.exp_se3(T(xi))
    for v in range(7):
        jR, jt = jse3.exp_se3(jnp.asarray(xi[v]))
        close(dR[v], jR, "float64")
        close(dt[v], jt, "float64")
    Rc, tc = tse3.compose(dR, dt, T(R), T(t))
    close(Rc[3], np.asarray(dR[3]) @ R[3], "float64")
    close(tc[3], np.asarray(dR[3]) @ t[3] + np.asarray(dt[3]), "float64")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", MODELS)
def test_residuals_cost_jacobians(model, dtype):
    jp, tp = both(scene(3, model), dtype)
    close(tba.residuals(tp), jba.residuals(jp), dtype)
    jc, tc = jba.cost(jp), tba.cost(tp)
    assert tc.dtype == torch.float64 and jc.dtype == jnp.float64
    close(tc, jc, dtype)
    for got, want in zip(tba._jacobians(tp), jba._jacobians(jp)):
        close(got, want, dtype)
    assert tba.n_intr(model) == jba.n_intr(model)
    with pytest.raises(ValueError):
        tba._project("fisheye", tp.points, tp.intr)


def _system_inputs(model, dtype, seed=4):
    """Scaled jacobians of a scene, from the JAX package (so that every
    function below is held against it on the same inputs)."""
    jp, tp = both(scene(seed, model), dtype)
    V = jp.R.shape[0]
    Jv, Jp, r = jba._jacobians(jp)
    Jv_s, Jp_s, s_v, s_p = jba._scale_jacobians(jp.obs_view, Jv, Jp, V)
    return jp, tp, V, (Jv, Jp, r), (Jv_s, Jp_s, s_v, s_p)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", MODELS)
def test_scale_jacobians_and_point_blocks(model, dtype):
    jp, tp, V, (Jv, Jp, r), scaled = _system_inputs(model, dtype)
    got = tba._scale_jacobians(tp.obs_view, T(Jv), T(Jp), V)
    for g, w in zip(got, scaled):
        close(g, w, dtype)
    # a diagonal reduced beforehand is taken as given
    diag = np.full(scaled[2].shape, 4.0, dtype)
    g = tba._scale_jacobians(tp.obs_view, T(Jv), T(Jp), V, hvv_diag=T(diag))
    w = jba._scale_jacobians(jp.obs_view, Jv, Jp, V,
                             hvv_diag=jnp.asarray(diag))
    for a, b in zip(g, w):
        close(a, b, dtype)
    Jv_s, Jp_s = scaled[:2]
    for solve in (None, "float64"):
        want = jba._point_blocks(Jv_s, Jp_s, r, 1e-3,
                                 jnp.dtype(solve or dtype))
        got = tba._point_blocks(T(Jv_s), T(Jp_s), T(r), 1e-3,
                                getattr(torch, solve or dtype))
        for a, b in zip(got, want):
            close(a, b, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", MODELS)
def test_local_system(model, dtype):
    """At these sizes the JAX side takes its one-hot-matmul branch
    (P * V * 3 * D is far below 32e6); the port has one assembly, a sorted
    segmented sum."""
    jp, tp, V, (_, _, r), (Jv_s, Jp_s, _, _) = _system_inputs(model, dtype)
    P, D = Jv_s.shape[0], Jv_s.shape[-1]
    assert P * V * 3 * D <= 32_000_000
    for solve, lam in ((None, 1e-3), ("float64", jnp.asarray(0.5, dtype))):
        want = jba._local_system(jp.obs_view, Jv_s, Jp_s, r, lam, V,
                                 solve_dtype=solve and jnp.dtype(solve))
        tlam = lam if isinstance(lam, float) else T(lam)
        got = tba._local_system(tp.obs_view, T(Jv_s), T(Jp_s), T(r), tlam, V,
                                solve_dtype=solve and getattr(torch, solve))
        assert got[0].shape == (V, V, D, D)
        for a, b in zip(got, want):
            close(a, b, dtype)


@pytest.mark.parametrize("solve", (None, "float64"))
@pytest.mark.parametrize("refine", (0, 2))
@pytest.mark.parametrize("dtype", DTYPES)
def test_solve_reduced(dtype, refine, solve):
    """Snavely scene: views 0 and 1 are fixed, their intrinsics stay free.
    The float32 factorisation without refinement carries cond(S) * eps, so
    the two packages agree to 1e-3 of the largest entry there; every other
    case to the file's tolerance."""
    jp, tp, V, (_, _, r), (Jv_s, Jp_s, _, _) = _system_inputs("snavely",
                                                              dtype)
    S, gv_t = jba._local_system(jp.obs_view, Jv_s, Jp_s, r, 1e-3, V)[:2]
    want = jba._solve_reduced(S, gv_t, jp.fixed_views, 1e-3,
                              solve_dtype=solve and jnp.dtype(solve),
                              refine_steps=refine)
    got = tba._solve_reduced(T(S), T(gv_t), tp.fixed_views, 1e-3,
                             solve_dtype=solve and getattr(torch, solve),
                             refine_steps=refine)
    low = dtype == "float32" and solve is None and refine == 0
    close(got, want, dtype, tol=1e-3 if low else None)
    got = got.numpy()
    assert (got[:2, :6] == 0).all() and (got[:2, 6:] != 0).all()
    assert (got[2:] != 0).all()


def test_indefinite_reduced_system_is_rejected_not_raised(monkeypatch):
    """A reduced system that is not positive definite gives a NaN step in
    both packages, no exception; in the LM loop the step is rejected, the
    state and cost stay, lam grows."""
    jp, tp, V, (_, _, r), (Jv_s, Jp_s, _, _) = _system_inputs("normalized",
                                                              "float64")
    S, gv_t = jba._local_system(jp.obs_view, Jv_s, Jp_s, r, 1e-3, V)[:2]
    want = jba._solve_reduced(-S, gv_t, jp.fixed_views, 1e-3)
    got = tba._solve_reduced(-T(S), T(gv_t), tp.fixed_views, 1e-3)
    assert np.isnan(np.asarray(want)[2:]).all()
    assert torch.isnan(got[2:]).all()

    real, calls = tba._local_system, []

    def negated_twice(*a, **k):
        out = real(*a, **k)
        calls.append(1)
        return (-out[0],) + out[1:] if len(calls) <= 2 else out

    monkeypatch.setattr(tba, "_local_system", negated_twice)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out, info = tba.optimize(tp, iterations=6)
    costs = info["costs"].numpy()
    c0 = float(info["initial_cost"])
    assert costs[0] == c0 and costs[1] == c0 and costs[2] < c0
    assert float(info["final_cost"]) < 0.1 * c0
    assert torch.isfinite(out.R).all() and torch.isfinite(out.points).all()


def test_invalid_slots_leave_view_0_alone():
    """Invalid slots carry view 0 and (here) garbage pixels; with no valid
    observation in view 0, every sum over views leaves it exactly zero."""
    d = scene(6, "normalized", V=6, P=40, L=5)
    rng = np.random.default_rng(0)
    in_view0 = d["obs_valid"] & (d["obs_view"] == 0)
    d["obs_valid"] = d["obs_valid"] & ~in_view0
    d["obs_xy"] = np.where(d["obs_valid"][..., None], d["obs_xy"],
                           rng.normal(size=d["obs_xy"].shape))
    d["obs_view"] = np.where(d["obs_valid"], d["obs_view"], 0).astype(np.int32)
    assert (~d["obs_valid"]).sum() > 40
    jp, tp = both(d)
    V = 6
    Jv, Jp, r = tba._jacobians(tp)
    close(tba.residuals(tp), jba.residuals(jp), "float64")
    Jv_s, Jp_s, s_v, s_p = tba._scale_jacobians(tp.obs_view, Jv, Jp, V)
    assert (s_v[0] == 1e-6).all() and (s_v[1:] > 1e-6).all()
    S, gv_t = tba._local_system(tp.obs_view, Jv_s, Jp_s, r, 1e-3, V)[:2]
    assert (S[0] == 0).all() and (S[:, 0] == 0).all() and (gv_t[0] == 0).all()
    jS, jg = jba._local_system(
        jp.obs_view, *jba._scale_jacobians(jp.obs_view,
                                           *jba._jacobians(jp)[:2], V)[:2],
        jnp.asarray(r.numpy()), 1e-3, V)[:2]
    close(S, jS, "float64")
    close(gv_t, jg, "float64")


@pytest.mark.parametrize("dtype", DTYPES)
def test_summation_agrees_with_index_add(dtype):
    """The sorted segmented sums against ``index_add_`` on the CPU (which
    adds in index order there): by view, and by view pair."""
    rng = np.random.default_rng(2)
    P, L, V, D = 40, 5, 6, 6
    view = torch.from_numpy(rng.integers(0, V, (P, L)).astype(np.int32))
    order = tba._view_order(view, V)
    x = torch.from_numpy(rng.normal(size=(P, L, D, D)).astype(dtype))
    want = torch.zeros((V, D, D), dtype=x.dtype).index_add_(
        0, view.reshape(-1).long(), x.reshape(-1, D, D))
    got = tba._sum_by_view(x, order)
    assert torch.equal(got, tba._sum_by_view(x, order))
    close(got, want.numpy(), dtype, tol=1e-6 if dtype == "float32" else 1e-14)
    y = torch.from_numpy(rng.normal(size=(P, L, L, D)).astype(dtype))
    key = (view.long()[:, :, None] * V + view.long()[:, None, :]).reshape(-1)
    want = torch.zeros((V * V, D), dtype=y.dtype).index_add_(
        0, key, y.reshape(-1, D))
    got = tba._segment_sum(y.reshape(-1, D), order.pair_perm,
                           order.pair_offsets)
    close(got, want.numpy(), dtype, tol=1e-6 if dtype == "float32" else 1e-14)
    # a view nobody observes sums to zero
    order = tba._view_order(view.clamp(max=V - 2), V)
    assert (tba._sum_by_view(x, order)[V - 1] == 0).all()
    # with the valid mask an invalid slot (view 0) is added nowhere: what
    # it holds is not read, and the sums are those of the zeroed terms
    valid = torch.from_numpy(rng.random((P, L)) < 0.7)
    view0 = torch.where(valid, view, 0)
    masked = tba._view_order(view0, V, valid)
    zeroed = torch.where(valid[..., None, None], x, 0.0)
    want = torch.zeros((V, D, D), dtype=x.dtype).index_add_(
        0, view0.reshape(-1).long(), zeroed.reshape(-1, D, D))
    got = tba._sum_by_view(x, masked)
    close(got, want.numpy(), dtype, tol=1e-6 if dtype == "float32" else 1e-14)
    assert torch.equal(got, tba._sum_by_view(zeroed,
                                             tba._view_order(view0, V)))
    pair_valid = (valid[:, :, None] & valid[:, None, :])[..., None]
    key0 = (view0.long()[:, :, None] * V + view0.long()[:, None, :])
    want = torch.zeros((V * V, D), dtype=y.dtype).index_add_(
        0, key0.reshape(-1), torch.where(pair_valid, y, 0.0).reshape(-1, D))
    got = tba._segment_sum(y.reshape(-1, D), masked.pair_perm,
                           masked.pair_offsets)
    close(got, want.numpy(), dtype, tol=1e-6 if dtype == "float32" else 1e-14)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", MODELS)
def test_back_substitute_and_apply_step(model, dtype):
    jp, tp, V, (_, _, r), (Jv_s, Jp_s, _, _) = _system_inputs(model, dtype)
    _, _, Hpp_inv, W, gp = jba._local_system(jp.obs_view, Jv_s, Jp_s, r,
                                             1e-3, V)
    rng = np.random.default_rng(5)
    dv = rng.normal(0, 0.01, (V, Jv_s.shape[-1])).astype(dtype)
    want = jba._back_substitute(jp.obs_view, Hpp_inv, W, gp, jnp.asarray(dv))
    got = tba._back_substitute(tp.obs_view, T(Hpp_inv), T(W), T(gp), T(dv))
    close(got, want, dtype)
    dp = rng.normal(0, 0.01, jp.points.shape).astype(dtype)
    want = jba._apply_step(jp, jnp.asarray(dv), jnp.asarray(dp))
    got = tba._apply_step(tp, T(dv), T(dp))
    for k in ("R", "t", "intr", "points"):
        close(getattr(got, k), getattr(want, k), dtype)
    assert got.model == model and got.obs_xy is tp.obs_xy


@pytest.mark.parametrize("model", MODELS)
def test_optimize_f64_matches_jax(model):
    """float64, 15 iterations: per-iteration costs within 1e-6 relative,
    R, t and points within 1e-7 (absolute)."""
    jp, tp = both(scene(7, model, noise=NOISE))
    jout, jinfo = jba.optimize(jp, iterations=15)
    tout, tinfo = tba.optimize(tp, iterations=15)
    np.testing.assert_allclose(tinfo["costs"].numpy(),
                               np.asarray(jinfo["costs"]), rtol=1e-6)
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]),
                                   rtol=1e-6)
    for k in ("R", "t", "points"):
        np.testing.assert_allclose(getattr(tout, k).numpy(),
                                   np.asarray(getattr(jout, k)), atol=1e-7)
    np.testing.assert_allclose(tout.intr.numpy(), np.asarray(jout.intr),
                               rtol=1e-7)
    costs = tinfo["costs"].numpy()
    assert (np.diff(costs) <= 0).all() and costs[-1] < 1e-2 * float(
        tinfo["initial_cost"])
    assert tout.points.dtype == torch.float64 and costs.shape == (15,)


def test_optimize_f32_mixed_reaches_noise_floor():
    """float32 with mixed precision (the default there): both packages end
    below the reference test's bar, rms < 2.5 * noise, and their final
    costs are within 5 % of each other."""
    d = scene(5, "normalized", noise=NOISE)
    jp, tp = both(d, "float32")
    jout, jinfo = jba.optimize(jp, iterations=15)
    tout, tinfo = tba.optimize(tp, iterations=15)
    assert tout.points.dtype == torch.float32 and tout.R.dtype == torch.float32
    n_obs = d["obs_valid"].sum()
    for info in (jinfo, tinfo):
        rms = np.sqrt(2 * float(info["final_cost"]) / (2 * n_obs))
        assert rms < 2.5 * NOISE, rms
    assert abs(float(tinfo["final_cost"]) / float(jinfo["final_cost"]) - 1) \
        < 0.05
    costs = tinfo["costs"].numpy()
    assert (np.diff(costs) <= 0).all()
    # the same solve again: the same bits
    again, info2 = tba.optimize(tp, iterations=15)
    assert torch.equal(again.R, tout.R) and torch.equal(again.points,
                                                        tout.points)
    assert torch.equal(info2["costs"], tinfo["costs"])
    # without mixed precision the solve still descends
    _, plain = tba.optimize(tp, iterations=15, mixed_precision=False)
    assert float(plain["final_cost"]) < 0.1 * float(plain["initial_cost"])


def test_optimize_zero_iterations_and_lam_bounds():
    _, tp = both(scene(8))
    out, info = tba.optimize(tp, iterations=0)
    assert info["costs"].shape == (0,)
    assert float(info["final_cost"]) == float(info["initial_cost"])
    assert torch.equal(out.points, tp.points)


def test_problem_numpy_round_trip_and_make_problem(monkeypatch):
    d = scene(9, "snavely")
    prob = tba.problem_from_numpy(d, device="cpu")
    back = tba.problem_to_numpy(prob)
    assert set(back) == set(d)
    for k, v in d.items():
        if k == "model":
            assert back[k] == v
        else:
            assert back[k].dtype == v.dtype
            np.testing.assert_array_equal(back[k], v)
    made = tba.make_problem(d["R"], d["t"], d["points"], d["obs_xy"],
                            d["obs_view"], d["obs_valid"], intr=d["intr"],
                            model="snavely", dtype=torch.float32,
                            device="cpu")
    assert made.R.dtype == torch.float32 and made.obs_view.dtype == torch.int32
    assert made.fixed_views.tolist() == [True] + [False] * 5
    assert made.intr.shape == (6, 3) and made.obs_valid.dtype == torch.bool
    jmade = jba.make_problem(d["R"], d["t"], d["points"], d["obs_xy"],
                             d["obs_view"], d["obs_valid"], intr=d["intr"],
                             model="snavely", dtype=jnp.float32)
    for k in jba.BAProblem._fields[:-1]:
        np.testing.assert_array_equal(getattr(made, k).numpy(),
                                      np.asarray(getattr(jmade, k)))
    plain = tba.make_problem(d["R"], d["t"], d["points"], d["obs_xy"],
                             d["obs_view"], d["obs_valid"], device="cpu")
    assert plain.intr.shape == (6, 0) and plain.model == "normalized"
    assert plain.points.dtype == torch.float64
    # without a card the default device raises; nothing runs on the CPU
    # unasked
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tba.make_problem(d["R"], d["t"], d["points"], d["obs_xy"],
                         d["obs_view"], d["obs_valid"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tba.problem_from_numpy(d)
