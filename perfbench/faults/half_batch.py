"""Fault for the harness's own tests: the batched step leaves the second
half of the streams out (they keep the state they were given)."""

import torch


def apply(port):
    sv = port.stereo_vo
    orig = sv.make_batched_step

    def make_broken(*a, **k):
        step = orig(*a, **k)

        def step_broken(states, lefts, rights):
            new, metrics = step(states, lefts, rights)
            b = states.xs.shape[0]
            keep = torch.arange(b, device=states.xs.device) >= b // 2
            mixed = sv._map_tensors(
                lambda x, y: torch.where(
                    keep.reshape((b,) + (1,) * (x.dim() - 1)), y, x),
                new, states)
            return mixed, metrics
        return step_broken

    sv.make_batched_step = make_broken

    def undo():
        sv.make_batched_step = orig
    return undo
