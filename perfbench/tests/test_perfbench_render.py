"""The device renderer (``traffic/render.py``, torch) against its frozen
numpy copy (``traffic/render_np.py``) on the same random grids."""

import numpy as np
import torch

from traffic import render, render_np

SCENE = {"texture_size": 64, "octaves": 4, "texture_scale": 6.0,
         "plane_origin": [0.0, 0.0, 8.0], "plane_x": [1.0, 0.0, 0.0],
         "plane_y": [0.0, 1.0, -0.15], "yaw_per_frame": 0.002,
         "creep_per_frame": [0.01, 0.0, 0.05]}
CAMERA = {"width": 48, "height": 40, "fx": 40.0, "fy": 40.0, "cx": 24.0,
          "cy": 20.0, "baseline": 0.4}


def _texture(seed=2 ** 31 + 5):
    grids = render.texture_grids(seed, SCENE["texture_size"],
                                 SCENE["octaves"], "cpu")
    return grids, render.noise_texture(grids, SCENE["texture_size"])


def test_noise_texture_matches_numpy():
    grids, tex = _texture()
    ref = render_np.noise_texture([g.numpy() for g in grids],
                                  SCENE["texture_size"])
    np.testing.assert_allclose(tex.numpy(), ref, rtol=0, atol=1e-4)


def test_render_plane_matches_numpy():
    _, tex = _texture()
    plane = {k: SCENE[k] for k in ("plane_origin", "plane_x", "plane_y",
                                   "texture_scale")}
    K = render.camera_matrix(CAMERA)
    for i in (0, 7):
        R, t = render.rig_pose(i, SCENE)
        got = render.render_plane(tex, K, R, t, CAMERA["height"],
                                  CAMERA["width"], **plane).numpy()
        want = render_np.render_plane(tex.numpy(), K, R, t, CAMERA["height"],
                                      CAMERA["width"], **plane)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        same = render.quantise(torch.from_numpy(got)).numpy() \
            == render_np.quantise(want)
        assert same.mean() > 0.999


def test_sequence_is_a_function_of_the_seed():
    a = render.render_sequence(12345678901, CAMERA, SCENE, 3, "cpu")
    b = render.render_sequence(12345678901, CAMERA, SCENE, 3, "cpu")
    c = render.render_sequence(12345678902, CAMERA, SCENE, 3, "cpu")
    assert a[0].dtype == torch.uint8 and a[0].shape == (3, 40, 48)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    # the rig moves: consecutive frames differ, the right view differs
    assert not torch.equal(a[0][0], a[0][2])
    assert not torch.equal(a[0][0], a[1][0])
