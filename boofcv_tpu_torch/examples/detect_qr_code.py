"""Render and detect QR codes in an image (port of
``boofcv_tpu/examples/detect_qr_code.py``).

Reference analog: examples/fiducial/ExampleDetectQrCode.java +
ExampleRenderQrCode.java — generate a QR, embed it in a scene, detect
position patterns, sample the grid, decode the message. The JAX example's
``--tpu`` flag and ``setup_backend`` have no counterpart: ``--device`` picks
the device.

    python -m boofcv_tpu_torch.examples.detect_qr_code [--device cpu|cuda]
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch._config import resolve_device
from boofcv_tpu_torch.examples import parse_device
from boofcv_tpu_torch.recognition.qr import code as qr
from boofcv_tpu_torch.recognition.qr import detector

MESSAGES = ["BoofCV on TPU", "hello 12345"]


def _scene():
    """One 260x280 scene a message: its version-2 code pasted on grey,
    sigma-2 noise (the noise of both scenes from one generator)."""
    rng = np.random.default_rng(10)
    scenes = []
    for i, msg in enumerate(MESSAGES):
        img = detector.render(qr.encode(msg, 2, "M", 3), module_px=4)
        scene = np.full((260, 280), 200.0, np.float32)
        y0, x0 = 30 + 10 * i, 40 + 15 * i
        scene[y0:y0 + img.shape[0], x0:x0 + img.shape[1]] = img
        scene += rng.normal(0, 2, scene.shape)
        scenes.append(scene)
    return scenes


def main(argv=None) -> int:
    dev = resolve_device(parse_device(argv))
    print(f"device: {dev}")
    decoded = []
    for i, scene in enumerate(_scene()):
        data, info = detector.detect_and_decode(scene, device=dev)
        text = data.decode() if isinstance(data, (bytes, bytearray)) \
            else data
        decoded.append(text)
        print(f"scene {i}: decoded {text!r}")
    ok = decoded == MESSAGES
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
