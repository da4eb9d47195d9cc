"""Host-side union-find (disjoint sets) for the merge finishers (the
port's copy of ``boofcv_tpu/utils/unionfind.py``).

Path-halving ``find``; ``union(a, b)`` makes ``b``'s root point at ``a``'s,
so a set's root is not its smallest member, and :meth:`labels` numbers the
sets in the order of their root ids.  ``segment_mean_shift``'s label
numbering depends on exactly this rule (its native merge keeps it).
"""

from __future__ import annotations

import numpy as np


class UnionFind:
    """Array-backed disjoint sets over ids ``0..n-1``."""

    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, a: int) -> int:
        p = self.parent
        while p[a] != a:
            p[a] = p[p[a]]
            a = p[a]
        return a

    def union(self, a: int, b: int) -> int:
        """Merge the sets of ``a`` and ``b``; returns the surviving root
        (``a``'s)."""
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra
        return ra

    def roots(self) -> np.ndarray:
        """[n] root id per element."""
        return np.array([self.find(i) for i in range(len(self.parent))])

    def labels(self) -> np.ndarray:
        """[n] compact 0-based labels, one per set, in root-id order."""
        _, lab = np.unique(self.roots(), return_inverse=True)
        return lab
