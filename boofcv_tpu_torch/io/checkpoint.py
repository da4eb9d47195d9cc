"""Checkpoint / resume for long-running jobs (port of
``boofcv_tpu/io/checkpoint.py``): scene structure, trajectories and named
arrays round-trip through a single ``.npz``.  Host code.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from boofcv_tpu_torch.geo.ba import (BAProblem, problem_from_numpy,
                                     problem_to_numpy)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_arrays(path: str, **named_arrays) -> None:
    """Save named arrays (numpy, or tensors on any device) to one
    compressed npz."""
    np.savez_compressed(path, **{k: _np(v) for k, v in named_arrays.items()})


def load_arrays(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save_ba_problem(path: str, prob: BAProblem) -> None:
    d = problem_to_numpy(prob)
    d["model"] = np.frombuffer(prob.model.encode(), dtype=np.uint8)
    np.savez_compressed(path, **d)


def load_ba_problem(path: str, device=None) -> BAProblem:
    """The saved problem on ``device`` (None: the card; raises
    ``RuntimeError`` without one)."""
    d = load_arrays(path)
    d["model"] = d["model"].tobytes().decode()
    return problem_from_numpy(d, device=device)


def save_trajectory(path: str, poses: List[Tuple[np.ndarray, np.ndarray]],
                    frame_ids=None) -> None:
    """Save a VO trajectory: list of (R [3,3], t/center [3])."""
    Rs = np.stack([_np(R) for R, _ in poses])
    ts = np.stack([_np(t) for _, t in poses])
    if frame_ids is None:
        frame_ids = np.arange(len(poses))
    np.savez_compressed(path, R=Rs, t=ts, frame_ids=_np(frame_ids))


def load_trajectory(path: str):
    z = load_arrays(path)
    return ([(z["R"][i], z["t"][i]) for i in range(len(z["R"]))],
            z["frame_ids"])
