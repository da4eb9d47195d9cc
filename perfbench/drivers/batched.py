"""B streams through the port's batched entry points:
``make_batched_bootstrap`` on a replay's first frame, then
``make_batched_step``.

The rendered frames stay on the device; stream b replays frames
b * stream_offset ... + frames_per_replay - 1, so every stream sees a
different sequence.  A step hands the port one [B, H, W] stack of 8-bit
frames a camera and reads every stream's pose and pose_ok back to the
host in one copy.  Each replay starts from a fresh stacked state, stream
b's RANSAC generator seeded from the run's seed, the replay's number and b.
"""

from __future__ import annotations

import numpy as np
import torch

from traffic.render import camera_matrix


class Driver:
    def __init__(self, port, cfg, camera: dict, traffic: dict, frames,
                 device, seed_of):
        self.lefts, self.rights = frames
        self.streams = b = traffic["streams"]
        self.cfg = cfg
        self.camera = camera
        self.device = device
        self.seed_of = seed_of
        self.sv = port.stereo_vo
        K = camera_matrix(camera)
        self.boot = self.sv.make_batched_bootstrap(cfg, K, camera["baseline"],
                                                   device=device)
        self.step_fn = self.sv.make_batched_step(cfg, K, camera["baseline"],
                                                 device=device)
        off = traffic["stream_offset"]
        self.frame_lists = [[i * off + j for i in range(b)]
                            for j in range(traffic["frames_per_replay"])]
        self.index = [torch.tensor(f, device=device)
                      for f in self.frame_lists]
        self.state = None

    def reset(self, replay: int) -> None:
        self.state = self.sv.init_batched_state(
            self.cfg, self.streams, self.camera["height"],
            self.camera["width"], seed=self.seed_of(replay),
            device=self.device)

    def step(self, j: int) -> dict:
        before = self.state
        idx = self.index[j]
        left = self.lefts.index_select(0, idx)
        right = self.rights.index_select(0, idx)
        if j == 0:
            after = self.boot(before, left, right)
            one = torch.ones((self.streams, 3), dtype=torch.float64,
                             device=left.device)
            flags = one * torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64,
                                       device=left.device)
        else:
            after, m = self.step_fn(before, left, right)
            flags = torch.stack([m["pose_ok"], m["alive"], m["inliers"]],
                                1).to(torch.float64)
        self.state = after
        # the one host read of a step: every stream's pose and flags
        host = torch.cat([after.R.reshape(self.streams, 9), after.t, flags],
                         1).cpu().numpy()
        return {"before": before, "after": after,
                "frames": self.frame_lists[j],
                # unusable: pose_ok false, or a pose that is not finite
                "failed": int(((host[:, 12] == 0)
                               | ~np.isfinite(host[:, :12]).all(1)).sum()),
                "spawned": j == 0 or bool((host[:, 13] > host[:, 14]).any())}
