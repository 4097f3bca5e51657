"""The benchmark's inputs, made from ``--seed``.

``make_corpus`` is a frozen copy of the repository's pinned generator
(``bench.py::make_corpus``, copied by the port as
``duckdb_lm_diskann_tpu_torch/utils/corpora.py``): a smooth manifold of
intrinsic dimension 12 embedded in ``dims``. With ``row_seed`` None it is
bit-identical to the original. With ``row_seed`` set, the manifold's
weights still come from ``seed`` and the rows from ``row_seed``: every run
seed then draws a different sample of one fixed manifold, so a seed changes
the rows and queries and not the shape of the work.

``Inputs`` lays one run's rows out in a fixed order: the base rows the
index is built from, the query pool, then (for a write mix) the stream of
fresh rows. Row id r is always row r of ``rows`` (base, then stream).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def make_corpus(n, dims, seed=0xBE7C4, zdim=12, row_seed=None):
    """(gen, rng): ``gen(m)`` draws m rows; ``rng`` continues the stream."""
    del n
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((zdim, 64)).astype(np.float32)
    w2 = (rng.standard_normal((64, dims)) / np.sqrt(64)).astype(np.float32)
    if row_seed is not None:
        rng = np.random.default_rng(row_seed)

    def gen(m):
        z = rng.standard_normal((m, zdim)).astype(np.float32)
        return np.tanh(z @ w1) @ w2 + 0.02 * rng.standard_normal(
            (m, dims)
        ).astype(np.float32)

    return gen, rng


def run_seed(seed: int) -> np.random.SeedSequence:
    """The run's seed sequence; any whole number (wider than 64 bits too)."""
    return np.random.SeedSequence(abs(int(seed)))


@dataclasses.dataclass
class Inputs:
    base: np.ndarray  # f32[n_base, D], row ids 0 .. n_base-1
    pool: np.ndarray  # f32[P, D], the queries a window cycles
    gen: object  # draws further stream rows, in order

    def __post_init__(self):
        self.blocks = []  # the stream rows drawn so far, block by block
        self.n_stream = 0

    def stream_slice(self, a: int, b: int) -> np.ndarray:
        """Stream rows a .. b-1 (row ids n_base + a ...), drawn on demand
        and always in the same order. A slice inside one block is a view:
        nothing is copied."""
        if b > self.n_stream:
            self.blocks.append(self.gen(b - self.n_stream).astype(np.float32))
            self.n_stream = b
        parts, start = [], 0
        for blk in self.blocks:
            lo, hi = max(a, start), min(b, start + len(blk))
            if lo < hi:
                parts.append(blk[lo - start:hi - start])
            start += len(blk)
        if len(parts) == 1:
            return parts[0]
        return np.concatenate(parts or [self.base[:0]])

    def stream_rows(self, n: int) -> np.ndarray:
        """The first ``n`` stream rows."""
        return self.stream_slice(0, n)

    def rows(self, n_live: int) -> np.ndarray:
        """Rows 0 .. n_live-1: the base, then the stream."""
        if n_live <= len(self.base):
            return self.base[:n_live]
        return np.concatenate(
            [self.base, self.stream_rows(n_live - len(self.base))]
        )


def make_inputs(config: dict, traffic: dict, seed: int) -> Inputs:
    """Base rows, the query pool and (``stream_rows`` in the mix) the first
    stream rows, drawn in that order from the run's seed."""
    rows_seed, = run_seed(seed).spawn(1)
    gen, _ = make_corpus(
        0, config["dims"], seed=config["manifold_seed"],
        row_seed=rows_seed,
    )
    base = gen(config["rows"]).astype(np.float32)
    pool = gen(traffic["pool"]).astype(np.float32)
    inputs = Inputs(base, pool, gen)
    inputs.stream_rows(traffic.get("stream_rows", 0))
    return inputs
