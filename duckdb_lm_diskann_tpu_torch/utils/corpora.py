"""Synthetic corpora with pinned generators.

``make_corpus`` is the port's own copy of ``bench.py::make_corpus``, the
generator every configuration of the repository's benchmark draws from (the
port imports nothing of the JAX package or of ``bench.py``). Same seed, same
vectors.
"""

from __future__ import annotations

import numpy as np


def make_corpus(n, dims, seed=0xBE7C4, zdim=12):
    """Smooth random manifold with intrinsic dimension 12 embedded in
    ``dims`` (z ~ N(0,I)^12 -> tanh(z W1) W2 + noise): the model of
    descriptor corpora (SIFT/GIST/DEEP vectors live on low-intrinsic-
    dimension manifolds with continuous neighborhoods). Returns (gen, rng):
    ``gen(m)`` draws m rows; ``rng`` continues the same stream (queries).
    ``n`` is unused, as in the original: callers pass it to ``gen``."""
    del n
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((zdim, 64)).astype(np.float32)
    w2 = (rng.standard_normal((64, dims)) / np.sqrt(64)).astype(np.float32)

    def gen(m):
        z = rng.standard_normal((m, zdim)).astype(np.float32)
        return np.tanh(z @ w1) @ w2 + 0.02 * rng.standard_normal(
            (m, dims)
        ).astype(np.float32)

    return gen, rng
