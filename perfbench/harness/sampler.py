"""The steps of the window that the reference checks: two reservoirs,
drawn with a generator seeded from the run's seed, one of ordinary steps
and one of steps that spawn (a replay's bootstrap among them).  A held
step keeps references to the states before and after it, which the step
made anyway, so holding costs the window nothing."""

from __future__ import annotations

import numpy as np


class Sampler:
    def __init__(self, seed: int, k_steps: int, k_spawn: int):
        self.rng = np.random.default_rng([int(seed) % (2 ** 63), 17])
        self.k = {False: k_steps, True: k_spawn}
        self.held = {False: [], True: []}
        self.seen = {False: 0, True: 0}

    def offer(self, j: int, out: dict) -> None:
        spawn = bool(j == 0 or out.get("spawned", False))
        self.seen[spawn] += 1
        held, k = self.held[spawn], self.k[spawn]
        if len(held) < k:
            held.append((j, out))
        else:
            i = int(self.rng.integers(0, self.seen[spawn]))
            if i < k:
                held[i] = (j, out)

    def items(self) -> list:
        return self.held[False] + self.held[True]
