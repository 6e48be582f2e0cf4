"""The one traffic generator: a mix file's parameters in, requests out.

A mix states a closed loop of ``clients`` users and the distributions of
prompt and output lengths (``lognormal``: ``median``, ``sigma``, clipped
to ``[min, max]``).  The lengths form one sequence for the mix, the same
for every seed: strata of ``STRATUM`` requests, each holding the
``STRATUM`` quantiles of each distribution (at (i + 1/2) / STRATUM) in an
arrangement drawn once from a fixed stream.  A seed starts the sequence at
its own offset (fewer than ``STRATUM`` requests in) and draws the prompt
tokens, uniform over the vocabulary.  So every seed offers the same work
in another order, and the window, which spans a few strata, sees nearly
the same lengths in nearly the same arrangement whatever the seed: in a
closed loop the tails depend on how long prompts and short answers fall
together, and a run's spread is then the system's, not the draw's.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import List, Tuple

import numpy as np

# the seed's streams: the offset and prompt tokens, the check's sample; and
# the fixed stream of the mix's arrangement
STREAM_TRAFFIC, STREAM_SAMPLE, STREAM_ARRANGEMENT = 1, 2, 3
STRATUM = 64


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of the run's seed (any whole number
    >= 0)."""
    return np.random.default_rng([int(seed), stream])


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """The ``n`` quantiles of a length distribution, as whole tokens."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.rint(spec["median"] * np.exp(spec["sigma"] * z)).astype(np.int64)
    return np.clip(x, spec["min"], spec["max"])


def generate(mix: dict, vocab: int, seed: int) -> List[Tuple[np.ndarray, int]]:
    """``mix["requests"]`` requests as (prompt token ids (int32), output
    length), in the order the loop sends them."""
    n = mix["requests"]
    fixed = rng(0, STREAM_ARRANGEMENT)
    strata = -(-n // STRATUM) + 1
    prompts = np.concatenate([fixed.permutation(quantile_lengths(mix["prompt"], STRATUM))
                              for _ in range(strata)])
    outputs = np.concatenate([fixed.permutation(quantile_lengths(mix["output"], STRATUM))
                              for _ in range(strata)])
    g = rng(seed, STREAM_TRAFFIC)
    start = int(g.integers(STRATUM))
    prompts, outputs = prompts[start:start + n], outputs[start:start + n]
    limit = mix["engine"]["max_len"]
    if int((prompts + outputs).max()) > limit:
        raise ValueError(f"a request of {int((prompts + outputs).max())} tokens exceeds "
                         f"max_len {limit}")
    tokens = g.integers(0, vocab, int(prompts.sum()), dtype=np.int32)
    cuts = np.cumsum(prompts)[:-1]
    return [(p, int(o)) for p, o in zip(np.split(tokens, cuts), outputs)]

