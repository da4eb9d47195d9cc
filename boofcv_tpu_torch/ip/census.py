"""Census transform (port of ``boofcv_tpu/ip/census.py``).

Reference analog: boofcv-ip alg/transform/census/*.  3x3 -> 8-bit and
5x5 -> 24-bit codes: each bit is (neighbour < centre), packed in raster
order skipping the centre; border pixels use EXTENDED neighbours.  Output
int32.
"""

from __future__ import annotations

import torch

from boofcv_tpu_torch.core.border import BorderType, pad


def _census(image: torch.Tensor, radius: int) -> torch.Tensor:
    p = pad(image, radius, radius, BorderType.EXTENDED)
    h, w = image.shape
    n = 2 * radius + 1
    out = torch.zeros((h, w), dtype=torch.int32, device=image.device)
    bit = 0
    for dy in range(n):
        for dx in range(n):
            if dy == radius and dx == radius:
                continue
            neighbor = p[dy:dy + h, dx:dx + w]
            out |= (neighbor < image).to(torch.int32) << bit
            bit += 1
    return out


def dense3x3(image: torch.Tensor) -> torch.Tensor:
    """8-bit census (CensusTransform.dense3x3)."""
    return _census(image, 1)


def dense5x5(image: torch.Tensor) -> torch.Tensor:
    """24-bit census (CensusTransform.dense5x5)."""
    return _census(image, 2)


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element popcount(a XOR b) of int32 words: the census matching
    cost.  SWAR bit tricks; ``>>`` on int32 is arithmetic and the multiply
    wraps, as in the reference, and every mask clears what the sign
    extension brought in."""
    x = torch.bitwise_xor(a, b)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24
