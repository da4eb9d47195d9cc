"""Homography decomposition (port of ``boofcv_tpu/geo/selfcalib.py``:
``homography_decompose``).

Reference analog: boofcv-geo alg/geo/h/HomographyDecomposition
(decomposeHomography), Faugeras' SVD method.  Numpy on the host, as in the
reference: the input is one 3x3 matrix.
"""

from __future__ import annotations

import numpy as np


def homography_decompose(H, K1=None, K2=None):
    """Decompose a metric homography H = R + t nᵀ / d into candidate
    (R, t/d, n) solutions.

    H maps normalized coords of view 1 to view 2 (pass K1, K2 to
    un-calibrate a pixel homography).  Returns a list of (R, t, n) numpy
    float64 triples: up to 4 solutions, each normal turned to n[2] >= 0
    (t negated with it)."""
    H = np.asarray(H, np.float64)
    if K1 is not None:
        H = np.linalg.inv(np.asarray(K2, np.float64)) @ H @ np.asarray(
            K1, np.float64)
    U, S, Vt = np.linalg.svd(H)
    H = H / S[1]
    U, S, Vt = np.linalg.svd(H)
    s = np.linalg.det(U) * np.linalg.det(Vt)
    d1, d2, d3 = S
    if abs(d1 - d3) < 1e-9:   # pure rotation
        return [(H, np.zeros(3), np.array([0.0, 0, 1]))]
    x1 = np.sqrt(max((d1 ** 2 - d2 ** 2) / (d1 ** 2 - d3 ** 2), 0.0))
    x3 = np.sqrt(max((d2 ** 2 - d3 ** 2) / (d1 ** 2 - d3 ** 2), 0.0))
    sols = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            n_p = np.array([e1 * x1, 0.0, e3 * x3])
            sin_t = e1 * e3 * x1 * x3 * (d1 - d3) / d2
            cos_t = (d2 ** 2 + d1 * d3) / ((d1 + d3) * d2)
            Rp = np.array([[cos_t, 0, -sin_t], [0, 1, 0], [sin_t, 0, cos_t]])
            tp = (d1 - d3) * np.array([e1 * x1, 0.0, -e3 * x3])
            R = s * U @ Rp @ Vt
            t = U @ tp
            n = Vt.T @ n_p
            if n[2] < 0:
                n = -n
                t = -t
            sols.append((R, t, n))
    return sols
