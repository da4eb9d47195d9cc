"""Camera-calibration serialization (YAML); port of
``boofcv_tpu/io/calibration_io.py``, numpy only, files written byte-equal to
the reference's.

Reference analog: boofcv-io io/calibration/CalibrationIO.java — YAML
save/load of CameraPinholeBrown and StereoParameters.  The on-disk format
here is a cleaner YAML mapping but carries the same fields so calibration
results round-trip; a BoofCV-format reader is provided for interop.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Optional

import numpy as np


@dataclass
class CameraPinholeBrown:
    """struct/calib/CameraPinholeBrown.java analog."""
    width: int
    height: int
    fx: float
    fy: float
    skew: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    radial: tuple = (0.0, 0.0)
    t1: float = 0.0
    t2: float = 0.0

    @property
    def K(self) -> np.ndarray:
        return np.array([[self.fx, self.skew, self.cx],
                         [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]])


@dataclass
class StereoParameters:
    """struct/calib/StereoParameters analog: two cameras + right_to_left."""
    left: CameraPinholeBrown
    right: CameraPinholeBrown
    R_right_to_left: np.ndarray
    t_right_to_left: np.ndarray


def _yaml_dump(obj, indent=0) -> str:
    pad = "  " * indent
    lines = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, dict) and v:
                lines.append(f"{pad}{k}:")
                lines.append(_yaml_dump(v, indent + 1))
            else:
                lines.append(f"{pad}{k}: {_scalar(v)}")
    return "\n".join(lines)


def _scalar(v):
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(str(float(x)) for x in v) + "]"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, (dict,)) and not v:
        return "{}"
    return str(v)


def _yaml_load(text: str):
    """Minimal YAML subset loader (mappings, nested by indent, inline
    [a, b] lists, and block sequences of scalars) — enough for our
    files and BoofCV's.  Block sequences matter for interop: SnakeYAML
    emits list-valued fields like ``radial`` as '- x' lines, which the
    previous loader silently mangled into bogus mapping keys (the
    loaded camera then had wrong distortion with no error)."""
    root: dict = {}
    stack = [(-1, root, None)]          # (indent, container, key-in-parent)
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip() or line.strip().startswith("---"):
            continue
        indent = len(line) - len(line.lstrip())
        stripped = line.strip()
        if stripped.startswith("- "):
            # block-sequence item: the enclosing key's value becomes a
            # list.  Items may sit at the SAME indent as their key
            # (SnakeYAML's default block style), so pop strictly-deeper
            # entries only.
            while len(stack) > 1 and stack[-1][0] > indent:
                stack.pop()
            parent_indent, parent, pkey = stack[-1]
            if pkey is not None:
                holder = stack[-2][1]
                if not isinstance(holder.get(pkey), list):
                    holder[pkey] = []
                holder[pkey].append(_parse_scalar(stripped[2:].strip()))
            continue
        key, _, val = stripped.partition(":")
        val = val.strip()
        while stack and stack[-1][0] >= indent:
            stack.pop()
        parent = stack[-1][1]
        if val == "":
            child: dict = {}
            parent[key] = child
            stack.append((indent, child, key))
        else:
            parent[key] = _parse_scalar(val)
    return root


def _parse_scalar(v: str):
    if v.startswith("[") and v.endswith("]"):
        inner = v[1:-1].strip()
        return [float(x) for x in inner.split(",")] if inner else []
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def save_pinhole_brown(cam: CameraPinholeBrown, path: str) -> None:
    d = {
        "model": "pinhole_brown",
        "width": cam.width, "height": cam.height,
        "fx": cam.fx, "fy": cam.fy, "skew": cam.skew,
        "cx": cam.cx, "cy": cam.cy,
        "radial": list(cam.radial), "t1": cam.t1, "t2": cam.t2,
    }
    with open(path, "w") as f:
        f.write("# boofcv_tpu camera calibration\n" + _yaml_dump(d) + "\n")


def load_pinhole_brown(path: str) -> CameraPinholeBrown:
    with open(path) as f:
        d = _yaml_load(f.read())
    # accept both our format and BoofCV's CalibrationIO pinhole layout
    if "pinhole" in d:  # BoofCV: {pinhole: {fx..}, model: ..., radial: ...}
        p = d["pinhole"]
        return CameraPinholeBrown(
            int(p.get("width", 0)), int(p.get("height", 0)),
            float(p["fx"]), float(p["fy"]), float(p.get("skew", 0.0)),
            float(p["cx"]), float(p["cy"]),
            tuple(float(x) for x in d.get("radial", [0.0, 0.0])),
            float(d.get("t1", 0.0)), float(d.get("t2", 0.0)))
    return CameraPinholeBrown(
        int(d["width"]), int(d["height"]), float(d["fx"]), float(d["fy"]),
        float(d.get("skew", 0.0)), float(d["cx"]), float(d["cy"]),
        tuple(float(x) for x in d.get("radial", [0.0, 0.0])),
        float(d.get("t1", 0.0)), float(d.get("t2", 0.0)))


def save_stereo(params: StereoParameters, path: str) -> None:
    R = np.asarray(params.R_right_to_left).reshape(-1)
    t = np.asarray(params.t_right_to_left).reshape(-1)
    d = {
        "model": "stereo",
        "left": _cam_dict(params.left),
        "right": _cam_dict(params.right),
        "rotation": [float(x) for x in R],
        "translation": [float(x) for x in t],
    }
    with open(path, "w") as f:
        f.write("# boofcv_tpu stereo calibration\n" + _yaml_dump(d) + "\n")


def _cam_dict(cam: CameraPinholeBrown) -> dict:
    return {"width": cam.width, "height": cam.height, "fx": cam.fx,
            "fy": cam.fy, "skew": cam.skew, "cx": cam.cx, "cy": cam.cy,
            "radial": list(cam.radial), "t1": cam.t1, "t2": cam.t2}


def _cam_from(d: dict) -> CameraPinholeBrown:
    return CameraPinholeBrown(
        int(d["width"]), int(d["height"]), float(d["fx"]), float(d["fy"]),
        float(d.get("skew", 0.0)), float(d["cx"]), float(d["cy"]),
        tuple(float(x) for x in d.get("radial", [0.0, 0.0])),
        float(d.get("t1", 0.0)), float(d.get("t2", 0.0)))


def load_stereo(path: str) -> StereoParameters:
    with open(path) as f:
        d = _yaml_load(f.read())
    return StereoParameters(
        _cam_from(d["left"]), _cam_from(d["right"]),
        np.asarray(d["rotation"], np.float64).reshape(3, 3),
        np.asarray(d["translation"], np.float64))
