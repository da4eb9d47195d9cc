"""The steps of the window that the reference checks: one reservoir a
stratum, drawn with a generator seeded from the run's seed.  The kind
names the strata, how many steps each holds, and the stratum of a step
(stereo VO: ordinary steps, and steps that spawn).  A held step keeps
references to what the step made anyway, so holding costs the window
nothing."""

from __future__ import annotations

import numpy as np


class Sampler:
    def __init__(self, seed: int, sizes: dict, stratum):
        """``sizes``: stratum -> steps held, in the order the check reads
        them; ``stratum(j, out)``: the stratum of step ``j``."""
        self.rng = np.random.default_rng([int(seed) % (2 ** 63), 17])
        self.k = dict(sizes)
        self.stratum = stratum
        self.held = {s: [] for s in self.k}
        self.seen = {s: 0 for s in self.k}

    def offer(self, j: int, out: dict) -> None:
        s = self.stratum(j, out)
        self.seen[s] += 1
        held, k = self.held[s], self.k[s]
        if len(held) < k:
            held.append((j, out))
        else:
            i = int(self.rng.integers(0, self.seen[s]))
            if i < k:
                held[i] = (j, out)

    def items(self) -> list:
        return [x for s in self.k for x in self.held[s]]
