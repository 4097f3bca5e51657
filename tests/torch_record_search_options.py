"""Record the JAX package's answers that ``tests/test_torch_search_options.py``
holds the port to, into ``tests/golden/torch_search_options_jax.npz``.

The options tests compare the port's ``Coordinator.search`` with the JAX
Coordinator's, option by option, on one graph that the JAX Coordinator
built from seeded data. Its index (tables, row-id <-> slot maps, entry
point) and every JAX answer with its ``last_search_stats`` are recorded
here once, so the tests themselves run no JAX program: a pytest worker
that has compiled many JAX programs can crash inside XLA's compile-cache
read or write, and the test running there fails with it. The JAX package
is the frozen reference, so the recording stays its answer.

Run from the repository root (about a minute on the CPU):

    python tests/torch_record_search_options.py
"""

import os
import sys

import numpy as np

OUT = os.path.join(
    os.path.dirname(__file__), "golden", "torch_search_options_jax.npz"
)

N, DIMS, NQ = 400, 16, 12
ROWIDS = np.arange(N, dtype=np.int64) * 3 + 1000
GRAPH_FIELDS = (
    "vectors", "neighbors", "valid", "edge_pos", "edge_neg", "edge_i8",
    "edge_i4", "edge_scale", "edge_f32", "dirty_rows",
)
STATS = ("queries", "hops", "nodes_visited", "distance_ops")

ALLOWED = ROWIDS[::4]
OPTIONS = {
    "n_seeds": dict(n_seeds=3),
    "allowed": dict(allowed_rowids=ALLOWED),
    "batch": dict(batch_size=5),
    "batch-E2-allowed": dict(batch_size=5, beam_width=2,
                             allowed_rowids=ALLOWED),
    "adaptive": dict(adaptive_seeds=2, seed_sample=64),
    "adaptive-batch": dict(adaptive_seeds=2, seed_sample=64, batch_size=5),
    "stream": dict(stream=True, lanes=4),
    "stream-adaptive": dict(stream=True, lanes=8, adaptive_seeds=2,
                            seed_sample=64),
    "stream-allowed-batch": dict(stream=True, lanes=4, batch_size=5,
                                 allowed_rowids=ALLOWED),
}


def data_and_queries():
    """The clustered corpus and the noisy queries near its points."""
    rng = np.random.default_rng(0xC0)
    centers = 3.0 * rng.standard_normal((8, DIMS)).astype(np.float32)
    data = centers[rng.integers(0, 8, N)] + rng.standard_normal(
        (N, DIMS)
    ).astype(np.float32)
    queries = data[rng.integers(0, N, NQ)] + 0.05 * rng.standard_normal(
        (NQ, DIMS)
    ).astype(np.float32)
    return data, queries


def _answer(rec, prefix, coord, got) -> None:
    rec[f"{prefix}/ids"], rec[f"{prefix}/dists"] = got
    for f in STATS:
        rec[f"{prefix}/{f}"] = np.int64(getattr(coord.last_search_stats, f))


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")

    from duckdb_lm_diskann_tpu.core.coordinator import (
        Coordinator as JaxCoordinator,
    )
    from tests.torch_configs import configs

    jax_cfg, _ = configs(dims=DIMS)
    data, q = data_and_queries()
    jc = JaxCoordinator(jax_cfg, initial_capacity=N)
    jc.bulk_build(ROWIDS.tolist(), data, max_batch=64)

    rec = {"queries": q, "capacity": np.int64(jc.capacity)}
    for f in GRAPH_FIELDS:
        rec[f"graph/{f}"] = np.asarray(getattr(jc.arrays, f))
    pairs = sorted(jc.allocator.rowid_to_slot.items())
    rec["rowid_to_slot"] = np.asarray(pairs, np.int64).reshape(-1, 2)
    rec["high_water"] = np.int64(jc.allocator.high_water)
    rec["entry_slot"] = np.int64(jc.entry_slot)
    rec["entry_rowid"] = np.int64(jc.entry_rowid)
    rec["slot_rowids"] = np.asarray(jc._slot_rowids)

    _answer(rec, "positional", jc, jc.search(q, 10, 32, 2))
    for name, opts in OPTIONS.items():
        _answer(rec, f"option/{name}", jc, jc.search(q, 8, 24, **opts))
    _answer(rec, "view", jc, jc.search(q, 5, view=jc.capture_view(3)))
    empty = JaxCoordinator(jax_cfg).search(q, 3, beam_width=2, stream=True)
    rec["empty_stream/ids"], rec["empty_stream/dists"] = empty

    np.savez_compressed(OUT, **rec)
    print(f"wrote {len(rec)} arrays to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
