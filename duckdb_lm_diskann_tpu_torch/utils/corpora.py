"""Synthetic corpora with pinned generators.

``make_corpus`` is the port's own copy of ``bench.py::make_corpus``, the
generator every configuration of the repository's benchmark draws from;
``make_hard_corpus`` and ``zipf_cluster_ids`` are its copies of
``duckdb_lm_diskann_tpu/utils/corpora.py``, the HARD recall stressor (the
port imports nothing of the JAX package or of ``bench.py``). Same seed,
same vectors.
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


def zipf_cluster_ids(rng: np.random.Generator, m: int, n_clusters: int,
                     exponent: float = 1.1) -> np.ndarray:
    """Cluster assignment with Zipf(exponent) mass over cluster ranks."""
    ranks = np.arange(1, n_clusters + 1, dtype=np.float64)
    p = ranks ** (-exponent)
    p /= p.sum()
    return rng.choice(n_clusters, size=m, p=p)


def make_hard_corpus(
    n: int,
    dims: int,
    seed: int = 0x4A2D,
    n_clusters: int = 256,
    zipf_exponent: float = 1.1,
    anisotropy_decades: float = 1.5,
    duplicate_fraction: float = 0.05,
):
    """Clustered + anisotropic + duplicate-heavy generator: Zipf-mass
    clusters (a few giant dense ones starve the alpha-prune of long-range
    edges, a long sparse tail risks disconnection), a per-cluster
    per-dimension scale log-uniform over ``anisotropy_decades`` decades
    (cached codes mis-rank harder), and ``duplicate_fraction`` of the rows
    exact copies of earlier rows (tie-break and dedup paths). Cluster
    centers are 4*N(0, I). Returns (gen, rng) like ``make_corpus``."""
    del n
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.standard_normal((n_clusters, dims)).astype(np.float32)
    scales = (
        10.0
        ** rng.uniform(-anisotropy_decades, 0.3, (n_clusters, dims))
    ).astype(np.float32)

    def gen(m: int) -> np.ndarray:
        cid = zipf_cluster_ids(rng, m, n_clusters, zipf_exponent)
        x = centers[cid] + scales[cid] * rng.standard_normal(
            (m, dims)
        ).astype(np.float32)
        n_dup = int(m * duplicate_fraction)
        if n_dup and m > 1:
            dst = rng.choice(m, n_dup, replace=False)
            src = rng.integers(0, m, n_dup)
            x[dst] = x[src]
        return x

    return gen, rng
