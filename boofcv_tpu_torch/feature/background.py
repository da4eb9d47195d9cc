"""Background models for fixed and panning cameras (port of
``boofcv_tpu/feature/background.py``).

Reference analog: boofcv-feature alg/background/ —
BackgroundStationaryBasic (running average + threshold),
BackgroundStationaryGaussian (per-pixel mean / variance),
BackgroundStationaryGmm (mixture of Gaussians), and the moving-camera
variants alg/background/moving/BackgroundMoving{Basic,Gaussian,Gmm}.java.

Every update and segment is elementwise over the pixels.  A moving model
lives in a fixed "home" frame; each frame carries a homography
home -> current.  Update: each model pixel is projected into the frame,
sampled with ``bilinear`` and updated where ``in_bounds``.  Segment: each
frame pixel looks the model up through the inverse homography; pixels the
model never saw are ``UNKNOWN``.  The projections run in the homography's
dtype promoted with float32 (float64 for a float64 homography, as the JAX
package computes them), and the inverse is ``inv_ex`` in float64 (no host
sync).  ``argmax`` / ``argmin`` take the first of tied components in both
packages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boofcv_tpu_torch._config import as_tensor, resolve_device
from boofcv_tpu_torch.ip import interpolate


def _f32(image, device=None) -> torch.Tensor:
    """``image`` as float32: a tensor stays where it is unless ``device``
    names another; anything else goes to ``device`` (None: the card)."""
    return as_tensor(image, device=device).to(torch.float32)


# ---------------------------------------------------------------------------
# Basic: exponential running average
# ---------------------------------------------------------------------------

def basic_init(image, device=None) -> torch.Tensor:
    return _f32(image, device)


def basic_update(model: torch.Tensor, image,
                 learn_rate: float = 0.05) -> torch.Tensor:
    return model + learn_rate * (_f32(image, model.device) - model)


def basic_segment(model: torch.Tensor, image,
                  threshold: float = 25.0) -> torch.Tensor:
    """1 = moving foreground (BackgroundStationaryBasic.segment)."""
    moving = torch.abs(_f32(image, model.device) - model) > threshold
    return moving.to(torch.uint8)


# ---------------------------------------------------------------------------
# Gaussian: per-pixel mean + variance
# ---------------------------------------------------------------------------

class GaussianModel(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor


def gaussian_init(image, initial_var: float = 100.0,
                  device=None) -> GaussianModel:
    img = _f32(image, device)
    return GaussianModel(img, torch.full_like(img, initial_var))


def gaussian_update(model: GaussianModel, image, learn_rate: float = 0.05,
                    min_var: float = 4.0) -> GaussianModel:
    d = _f32(image, model.mean.device) - model.mean
    mean = model.mean + learn_rate * d
    var = model.var + learn_rate * (d * d - model.var)
    return GaussianModel(mean, torch.clamp(var, min=min_var))


def gaussian_segment(model: GaussianModel, image,
                     threshold_sigma: float = 3.0) -> torch.Tensor:
    d2 = (_f32(image, model.mean.device) - model.mean) ** 2
    return (d2 > threshold_sigma ** 2 * model.var).to(torch.uint8)


# ---------------------------------------------------------------------------
# GMM: K Gaussians per pixel (Stauffer-Grimson, as BackgroundStationaryGmm)
# ---------------------------------------------------------------------------

class GmmModel(NamedTuple):
    means: torch.Tensor    # [K, H, W]
    vars: torch.Tensor     # [K, H, W]
    weights: torch.Tensor  # [K, H, W]


def gmm_init(image, k: int = 3, initial_var: float = 400.0,
             device=None) -> GmmModel:
    img = _f32(image, device)
    zeros = [torch.zeros_like(img)] * (k - 1)
    means = torch.stack([img] + zeros)
    return GmmModel(means, torch.full_like(means, initial_var),
                    torch.stack([torch.ones_like(img)] + zeros))


def gmm_update(model: GmmModel, image, learn_rate: float = 0.02,
               match_sigma: float = 3.0, initial_var: float = 400.0,
               min_var: float = 4.0) -> GmmModel:
    """One Stauffer-Grimson update step over every pixel."""
    img = _f32(image, model.means.device)[None]
    d2 = (img - model.means) ** 2
    match = (d2 < match_sigma ** 2 * model.vars) & (model.weights > 0)
    # only the best (highest-weight) matching component updates
    score = torch.where(match, model.weights, -1.0)
    best = torch.argmax(score, dim=0)[None]
    k_idx = torch.arange(model.means.shape[0],
                         device=img.device)[:, None, None]
    is_best = (k_idx == best) & match
    any_match = torch.any(match, dim=0, keepdim=True)
    rho = learn_rate
    means = torch.where(is_best, model.means + rho * (img - model.means),
                        model.means)
    vars_ = torch.where(is_best, torch.clamp(
        model.vars + rho * (d2 - model.vars), min=min_var), model.vars)
    weights = model.weights + learn_rate * (is_best.to(torch.float32)
                                            - model.weights)
    # no match: replace the weakest component with a fresh Gaussian
    weakest = torch.argmin(torch.where(model.weights > 0, model.weights,
                                       float("inf")), dim=0)[None]
    is_weakest = (k_idx == weakest) & ~any_match
    means = torch.where(is_weakest, img, means)
    vars_ = torch.where(is_weakest, initial_var, vars_)
    weights = torch.where(is_weakest, learn_rate, weights)
    wsum = torch.sum(weights, dim=0, keepdim=True)
    return GmmModel(means, vars_, weights / torch.clamp(wsum, min=1e-12))


def gmm_segment(model: GmmModel, image, match_sigma: float = 3.0,
                bg_weight: float = 0.3) -> torch.Tensor:
    """Foreground = matches no component of weight >= ``bg_weight``."""
    img = _f32(image, model.means.device)[None]
    d2 = (img - model.means) ** 2
    match_bg = ((d2 < match_sigma ** 2 * model.vars)
                & (model.weights >= bg_weight))
    return (~torch.any(match_bg, dim=0)).to(torch.uint8)


# ---------------------------------------------------------------------------
# Moving-camera variants
# ---------------------------------------------------------------------------

UNKNOWN = 2


def _homography(H, like: torch.Tensor) -> torch.Tensor:
    return as_tensor(H, device=like.device)


def _homog_apply(H: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """(u, v) = H (x, y, 1), in H's dtype promoted with the grid's."""
    dt = torch.promote_types(H.dtype, xs.dtype)
    H, xs, ys = H.to(dt), xs.to(dt), ys.to(dt)
    d = H[2, 0] * xs + H[2, 1] * ys + H[2, 2]
    d = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    u = (H[0, 0] * xs + H[0, 1] * ys + H[0, 2]) / d
    v = (H[1, 0] * xs + H[1, 1] * ys + H[1, 2]) / d
    return u, v


def _grid(shape_hw, device):
    h, w = shape_hw
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return xs.to(torch.float32), ys.to(torch.float32)


def _frame_sample(image: torch.Tensor, H: torch.Tensor, shape_hw):
    """The frame sampled at each model pixel: (values, seen)."""
    u, v = _homog_apply(H, *_grid(shape_hw, image.device))
    vals = interpolate.bilinear(image, v, u)
    return vals, interpolate.in_bounds(image.shape[:2], v, u)


def _current_grid(image: torch.Tensor, H: torch.Tensor):
    """Each frame pixel in home coordinates: (u, v) through H's inverse,
    computed in float64 and cast to float32 as the reference does."""
    Hinv = torch.linalg.inv_ex(H.to(torch.float64))[0].to(torch.float32)
    return _homog_apply(Hinv, *_grid(image.shape[:2], image.device))


def moving_init(shape_hw, device=None) -> torch.Tensor:
    """A moving model that has seen nothing: NaN everywhere."""
    return torch.full(tuple(shape_hw), float("nan"), dtype=torch.float32,
                      device=resolve_device(device))


def moving_basic_update(model: torch.Tensor, image, H_home_to_current,
                        learn_rate: float = 0.05) -> torch.Tensor:
    """BackgroundMovingBasic.updateBackground analog; NaN marks pixels the
    model has not seen yet (:func:`moving_init`)."""
    img = _f32(image, model.device)
    vals, seen = _frame_sample(img, _homography(H_home_to_current, img),
                               model.shape[:2])
    upd = torch.where(torch.isnan(model), vals,
                      model + learn_rate * (vals - model))
    return torch.where(seen, upd, model)


def _uint8_mask(moving, known) -> torch.Tensor:
    out = moving.to(torch.uint8)
    return torch.where(known, out, torch.full_like(out, UNKNOWN))


def moving_basic_segment(model: torch.Tensor, image, H_home_to_current,
                         threshold: float = 25.0) -> torch.Tensor:
    """0 background, 1 moving, 2 unknown, in the *current frame's* pixels."""
    img = _f32(image, model.device)
    u, v = _current_grid(img, _homography(H_home_to_current, img))
    mvals = interpolate.bilinear(model, v, u)
    known = (interpolate.in_bounds(model.shape[:2], v, u)
             & ~torch.isnan(mvals))
    return _uint8_mask(torch.abs(img - mvals) > threshold, known)


class MovingGaussianModel(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor


def moving_gaussian_init(shape_hw, device=None) -> MovingGaussianModel:
    return MovingGaussianModel(moving_init(shape_hw, device),
                               moving_init(shape_hw, device))


def moving_gaussian_update(model: MovingGaussianModel, image,
                           H_home_to_current, learn_rate: float = 0.05,
                           initial_var: float = 100.0,
                           min_var: float = 4.0) -> MovingGaussianModel:
    img = _f32(image, model.mean.device)
    vals, seen = _frame_sample(img, _homography(H_home_to_current, img),
                               model.mean.shape[:2])
    first = torch.isnan(model.mean)
    d = vals - model.mean
    mean = torch.where(first, vals, model.mean + learn_rate * d)
    var = torch.where(first, initial_var, torch.clamp(
        model.var + learn_rate * (d * d - model.var), min=min_var))
    return MovingGaussianModel(torch.where(seen, mean, model.mean),
                               torch.where(seen, var, model.var))


def moving_gaussian_segment(model: MovingGaussianModel, image,
                            H_home_to_current,
                            match_sigma: float = 3.0) -> torch.Tensor:
    img = _f32(image, model.mean.device)
    u, v = _current_grid(img, _homography(H_home_to_current, img))
    mean = interpolate.bilinear(model.mean, v, u)
    var = interpolate.bilinear(model.var, v, u)
    known = (interpolate.in_bounds(model.mean.shape[:2], v, u)
             & ~torch.isnan(mean))
    moving = (img - mean) ** 2 > (match_sigma ** 2) * torch.clamp(var,
                                                                  min=1e-6)
    return _uint8_mask(moving, known)


class MovingGmmModel(NamedTuple):
    weight: torch.Tensor  # [H, W, K]
    mean: torch.Tensor    # [H, W, K]
    var: torch.Tensor     # [H, W, K]


def moving_gmm_init(shape_hw, k: int = 3, device=None) -> MovingGmmModel:
    h, w = shape_hw
    dev = resolve_device(device)
    zeros = torch.zeros((h, w, k), dtype=torch.float32, device=dev)
    return MovingGmmModel(zeros, zeros.clone(),
                          torch.full((h, w, k), float("nan"), device=dev))


def moving_gmm_update(model: MovingGmmModel, image, H_home_to_current,
                      learn_rate: float = 0.02, initial_var: float = 400.0,
                      match_sigma: float = 3.0,
                      min_var: float = 4.0) -> MovingGmmModel:
    """BackgroundMovingGmm analog: the frame warped into home coordinates,
    then the GMM update on the pixels it covers."""
    img = _f32(image, model.mean.device)
    vals, seen = _frame_sample(img, _homography(H_home_to_current, img),
                               model.mean.shape[:2])
    x = vals[..., None]
    w_, mu, var = model.weight, model.mean, model.var
    k = w_.shape[-1]
    alive = ~torch.isnan(var)
    var_s = torch.where(alive, var, initial_var)
    d2 = (x - mu) ** 2
    match = alive & (d2 < (match_sigma ** 2) * var_s) & (w_ > 0)
    # the closest matching component wins
    best = torch.argmin(torch.where(match, d2 / var_s, float("inf")), dim=-1)
    onehot = torch.nn.functional.one_hot(best, k).to(torch.float32)
    any_match = torch.any(match, dim=-1, keepdim=True)
    own = onehot * any_match
    w_new = w_ + learn_rate * (own - w_)
    step = learn_rate / torch.clamp(w_new, min=1e-3)
    mu_new = torch.where(own > 0, mu + step * (x - mu), mu)
    var_new = torch.where(own > 0, torch.clamp(var_s + step * (d2 - var_s),
                                               min=min_var), var_s)
    # no match: replace the weakest component
    weakest = torch.argmin(torch.where(alive, w_, -1.0), dim=-1)
    replace = (torch.nn.functional.one_hot(weakest, k).to(torch.float32)
               * (1.0 - any_match.to(torch.float32)))
    w_new = torch.where(replace > 0, learn_rate, w_new)
    mu_new = torch.where(replace > 0, x, mu_new)
    var_new = torch.where(replace > 0, initial_var, var_new)
    w_new = w_new / torch.clamp(torch.sum(w_new, -1, keepdim=True),
                                min=1e-6)
    seen3 = seen[..., None]
    return MovingGmmModel(torch.where(seen3, w_new, w_),
                          torch.where(seen3, mu_new, mu),
                          torch.where(seen3, var_new, var))


def moving_gmm_segment(model: MovingGmmModel, image, H_home_to_current,
                       match_sigma: float = 3.0,
                       min_background_weight: float = 0.1) -> torch.Tensor:
    img = _f32(image, model.mean.device)
    u, v = _current_grid(img, _homography(H_home_to_current, img))
    mean = interpolate.bilinear(model.mean, v, u)
    var = interpolate.bilinear(model.var, v, u)
    wgt = interpolate.bilinear(model.weight, v, u)
    nan = torch.isnan(var)
    known = (interpolate.in_bounds(model.mean.shape[:2], v, u)
             & torch.any(~nan & (wgt > 0), dim=-1))
    x = img[..., None]
    ok = (~nan & (wgt >= min_background_weight)
          & ((x - mean) ** 2 < (match_sigma ** 2) * torch.clamp(
              torch.where(nan, 1.0, var), min=1e-6)))
    return _uint8_mask(~torch.any(ok, dim=-1), known)
