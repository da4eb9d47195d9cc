"""One stream through the port's front end: ``StereoVisualOdometry``.

Each frame pair is handed over from host memory as 8-bit arrays, as a
camera delivers it; ``process`` uploads it, runs the step (the bootstrap
on a replay's first frame) and reads the metrics and pose back.  Each
replay starts with ``reset``, its RANSAC generator seeded from the run's
seed and the replay's number.
"""

from __future__ import annotations

import numpy as np

from traffic.render import camera_matrix


class Driver:
    def __init__(self, port, cfg, camera: dict, traffic: dict, frames,
                 device, seed_of):
        lefts, rights = frames
        self.lefts = lefts.cpu().numpy()
        self.rights = rights.cpu().numpy()
        self.streams = 1
        self.seed_of = seed_of
        self.vo = port.stereo_vo.StereoVisualOdometry(
            cfg, camera_matrix(camera), camera["baseline"],
            camera["height"], camera["width"], seed=seed_of(0),
            device=device)

    def reset(self, replay: int) -> None:
        self.vo.reset(seed=self.seed_of(replay))

    def step(self, j: int) -> dict:
        """Frame ``j`` of the replay: the states before and after it, the
        frame index of each stream, how many poses came back unusable
        (pose_ok false, or not finite), and whether the step spawned
        tracks."""
        before = self.vo.state
        ok = self.vo.process(self.lefts[j], self.rights[j])
        ok = ok and all(np.isfinite(a).all()
                        for a in self.vo.camera_to_world())
        m = self.vo.metrics
        return {"before": before, "after": self.vo.state, "frames": [j],
                "failed": 0 if ok else 1,
                "spawned": j == 0 or m["alive"] > m["inliers"]}
