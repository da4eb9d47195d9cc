"""Stereo visual odometry: a configuration of ``"kind": "stereo_vo"``.

Set-up renders the configuration's scene on the device from the seed
(``traffic/render.py``) and builds the traffic's driver
(``drivers/<driver>.py``) over the port's ``StereoVoConfig``.  A step is
one frame, or one batched step of every stream's frame, handed to the
port until its pose is on the host.  The held steps are stratified on
whether the step spawned tracks (a replay's bootstrap among them), and
the check hands them to ``reference/check.py``.
"""

from __future__ import annotations

import types

import numpy as np

from traffic import render


def port():
    """The port's modules that drivers, faults and controls reach."""
    from boofcv_tpu_torch.feature import klt
    from boofcv_tpu_torch.sfm import stereo_vo
    return types.SimpleNamespace(klt=klt, stereo_vo=stereo_vo)


def seeds_of(seed: int):
    """replay -> the RANSAC seed of that replay (stream b adds b)."""
    return lambda replay: (int(seed) * 1_000_003 + 7919 * replay) % (2 ** 62)


def _state_np(state, b):
    """One stream's state as numpy (``b`` None: an unstacked state)."""
    pick = (lambda a: a) if b is None else (lambda a: a[b])
    a = lambda t: pick(t).detach().cpu().numpy()
    return {"xs": a(state.xs).astype(np.float64),
            "ys": a(state.ys).astype(np.float64),
            "world": a(state.world), "alive": a(state.alive),
            "R": a(state.R), "t": a(state.t), "uid": a(state.uid),
            "templates": {k: [a(x) for x in getattr(state.templates, k)]
                          for k in ("desc", "grad_x", "grad_y")}}


class Cell:
    """One run's frames and driver, built at set-up."""

    def __init__(self, bench, r, port, seed, device):
        self.bench, self.r, self.seed = bench, r, seed
        config, traffic = r["config"], r["traffic"]
        vo = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["vo"].items()}
        vo["klt"] = port.klt.KltConfig(**vo["klt"])
        self.frames = render.render_sequence(
            seed, config["camera"], config["scene"],
            traffic["rendered_frames"], device)
        self.driver = r["driver"].Driver(
            port, port.stereo_vo.StereoVoConfig(**vo), config["camera"],
            traffic, self.frames, device, seeds_of(seed))
        self.per_step = self.driver.streams
        self.steps = traffic["frames_per_replay"]
        self.check_settings = r["settings"]["check"]
        # ordinary steps first, then those that spawn
        self.strata = {"step": self.check_settings["steps"],
                       "spawn": self.check_settings["spawn_steps"]}

    def reset(self, replay: int) -> None:
        self.driver.reset(replay)

    def step(self, j: int) -> dict:
        return self.driver.step(j)

    @staticmethod
    def stratum(j: int, out: dict) -> str:
        return "spawn" if j == 0 or out.get("spawned", False) else "step"

    def check(self, held: list) -> dict:
        """The reference's numbers on the held ``(j, out)`` steps, each
        with its limit."""
        ref_check = self.bench.module("reference", "check")
        config = self.r["config"]
        lefts = self.frames[0].cpu().numpy()
        rights = self.frames[1].cpu().numpy()
        rng = np.random.default_rng([int(self.seed) % (2 ** 63), 29])
        cases = []
        for j, out in held:
            stacked = out["after"].xs.dim() == 2
            streams = [None] if not stacked else list(range(len(out["frames"])))
            states = [(_state_np(out["before"], b), _state_np(out["after"], b))
                      for b in streams]
            if stacked:
                # ``streams`` streams of every held step, and
                # ``spawn_streams`` of those that spawned in it
                spawned = [b for b, (s0, s1) in zip(streams, states)
                           if (s1["alive"] & (s1["uid"] != s0["uid"])).any()]
                keep = set(rng.permutation(streams)[
                    :self.check_settings["streams"]].tolist())
                keep |= set(rng.permutation(spawned)[
                    :self.check_settings["spawn_streams"]].tolist())
            else:
                keep = {None}
            for b, (s0, s1) in zip(streams, states):
                if b in keep:
                    f = out["frames"][0 if b is None else b]
                    cases.append({"s0": s0, "s1": s1, "left": lefts[f],
                                  "right": rights[f], "boot": j == 0})
        numbers = ref_check.compare(cases, config["vo"], config["fixed"],
                                    config["camera"])
        limits = self.r["settings"]["limits"]
        out = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
        # a check that saw no tracking step or no spawn has not covered the
        # path
        covered = (any(not c["boot"] for c in cases),
                   any(c["boot"] or bool((c["s1"]["alive"] & (
                       c["s1"]["uid"] != c["s0"]["uid"])).any())
                       for c in cases))
        out["uncovered"] = {"value": covered.count(False), "limit": 0}
        return out
