"""Closed-loop waves: one batch client whose batch is the engine's slot
count.  A wave's requests are submitted together; the next wave goes when
the last of them has finished.

Every request has the same lengths, as fixed-length throughput benchmarks
send them: a prompt of ``prompt`` token ids drawn from the seed (uniform
over the vocabulary) and ``new_tokens`` tokens decoded greedily with no
EOS.  Seeds differ in content, not in the amount of work.

Parameters (the cell file's ``traffic``): ``requests_per_wave``,
``prompt``, ``new_tokens``; ``source``, where the lengths come from, is
for the reader.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class Waves:
    def __init__(self, params: Dict, vocab_size: int, seed: int) -> None:
        self.n = int(params["requests_per_wave"])
        self.prompt = int(params["prompt"])
        self.new_tokens = int(params["new_tokens"])
        self.vocab_size = vocab_size
        self.seed = int(seed) % (1 << 64)

    def wave(self, index: int) -> List[Tuple[List[int], int]]:
        """Wave ``index`` of this seed (-1: the set-up's warm-up wave) as
        (prompt token ids, new tokens) pairs, in submission order."""
        rng = np.random.default_rng([self.seed, index + 1])
        ids = rng.integers(0, self.vocab_size, (self.n, self.prompt))
        return [(row.tolist(), self.new_tokens) for row in ids]


def make(params: Dict, vocab_size: int, seed: int) -> Waves:
    return Waves(params, vocab_size, seed)
