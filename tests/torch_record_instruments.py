"""Record the JAX package's answers that ``tests/test_torch_instruments.py``
holds the port's instruments to, into
``tests/golden/torch_instruments_jax.npz``:

  * ``real/``: the JAX ``beam_search`` (``benchmarks/profile_real.py``'s
    call: E = 1, ``assume_all_valid``, INT4 planar tables, plain XLA
    scoring) on ``real_tables()``'s 1,024 random rows at the caps V_LO
    and V_HI: top-k slots and distances and hops;
  * ``graph/``: a JAX Coordinator's build of the first N rows of a tiny
    HARD corpus (``index_data()``) at build batches of MAX_BATCH: every
    table, the entry point;
  * ``recall/<config>/``: its ``search`` answers (rowids, hops) for the
    baseline and one adaptive configuration of ``ab_hard_recall``;
  * ``insert/``: after two steady insert batches of MAX_BATCH new rows
    (``benchmarks/profile_insert.py``'s sequence), every table, and
    ``search_for_initial_candidates`` on the next batch's rows at beam
    widths 1 and 2 (hops, visited counts).

Recorded once, as ``tests/torch_record_serving.py`` does, so that the
port's tests run no JAX program in their pytest workers. Run from the
repository root (about a minute on the CPU):

    python tests/torch_record_instruments.py
"""

import os
import sys

import numpy as np

OUT = os.path.join(os.path.dirname(__file__), "golden",
                   "torch_instruments_jax.npz")

# profile_real's case: 2^10 rows, D = 128, R = 64, B = 8, L = 100.
REAL_CAP, REAL_B, REAL_L, REAL_K = 1 << 10, 8, 100, 10
V_LO, V_HI = 8, 16
# The index cases: a HARD corpus of N rows, then 3 batches of new rows.
N, DIMS, MAX_BATCH, NQ, K = 512, 16, 64, 24, 10
RECALL_CASES = {
    "baseline": {"l_search": 100},
    "adaptive": {"l_search": 100, "adaptive_seeds": 2, "seed_sample": 4096},
}
GRAPH_FIELDS = (
    "vectors", "neighbors", "valid", "edge_pos", "edge_neg", "edge_i8",
    "edge_i4", "edge_scale", "edge_f32", "dirty_rows",
)


def real_tables():
    """(vectors, neighbors, INT4 words u32, scales, [query batches]) of
    profile_real's case, from a seed."""
    rng = np.random.default_rng(0x9EA1)
    vectors = rng.standard_normal((REAL_CAP, 128)).astype(np.float32)
    neighbors = rng.integers(0, REAL_CAP, (REAL_CAP, 64), dtype=np.int32)
    words = rng.integers(0, 1 << 32, (REAL_CAP, 64, 16), dtype=np.uint64)
    scales = rng.random((REAL_CAP, 64)).astype(np.float32)
    queries = [rng.standard_normal((REAL_B, 128)).astype(np.float32)
               for _ in range(2)]
    return vectors, neighbors, words.astype(np.uint32), scales, queries


def index_data():
    """(rows [N + 3 * MAX_BATCH, DIMS], queries [NQ, DIMS], exact top-K
    rowids and distances of the queries over the first N rows)."""
    from duckdb_lm_diskann_tpu_torch.utils.corpora import make_hard_corpus

    gen, rng = make_hard_corpus(N + 3 * MAX_BATCH, DIMS, 0x4A2D)
    data = gen(N + 3 * MAX_BATCH)
    queries = data[rng.integers(0, N, NQ)] + 0.01 * rng.standard_normal(
        (NQ, DIMS)).astype(np.float32)
    diff = queries[:, None, :].astype(np.float64) - data[None, :N]
    dist = np.sqrt((diff * diff).sum(-1))
    ids = np.argsort(dist, axis=1, kind="stable")[:, :K]
    return data, queries, ids, np.take_along_axis(dist, ids, 1)


def index_options():
    """The index options of both sides' configs (tests/torch_configs.py)."""
    return dict(metric="l2", edge_type="int4", dims=DIMS)


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")

    from duckdb_lm_diskann_tpu.common.types import EdgeType, MetricType
    from duckdb_lm_diskann_tpu.core.coordinator import Coordinator
    from duckdb_lm_diskann_tpu.core.graph import GraphArrays, GraphParams
    from duckdb_lm_diskann_tpu.core.searcher import (
        beam_search,
        search_for_initial_candidates,
    )
    from tests.torch_configs import configs

    rec = {}
    vectors, neighbors, words, scales, queries = real_tables()
    cap = REAL_CAP
    arrays = GraphArrays(
        vectors=jnp.asarray(vectors),
        neighbors=jnp.asarray(neighbors),
        valid=jnp.ones(cap, jnp.bool_),
        edge_pos=jnp.zeros((cap, 0, 0), jnp.uint32),
        edge_neg=jnp.zeros((cap, 0, 0), jnp.uint32),
        edge_i8=jnp.zeros((cap, 0, 0), jnp.int8),
        edge_i4=jnp.asarray(words),
        edge_scale=jnp.asarray(scales),
        edge_f32=jnp.zeros((cap, 0, 0), jnp.float32),
        dirty_rows=jnp.zeros((cap,), jnp.bool_),
    )
    params = GraphParams(
        dims=128, r=64, metric=MetricType.L2, edge_type=EdgeType.INT4,
        alpha=1.2, l_insert=128, l_search=REAL_L, max_visits=4 * REAL_L,
        pallas="0", bitonic=False,
    )
    for v in (V_LO, V_HI):
        res = beam_search(
            arrays, jnp.asarray(queries[0]), jnp.int32(0), params=params,
            l_search=REAL_L, k=REAL_K, max_visits=v, assume_all_valid=True,
        )
        rec[f"real/{v}/topk_slots"] = np.asarray(res.topk_slots)
        rec[f"real/{v}/topk_dists"] = np.asarray(res.topk_dists)
        rec[f"real/{v}/hops"] = np.asarray(res.hops)

    data, queries, _, _ = index_data()
    jax_cfg, _ = configs(**index_options())
    coord = Coordinator(jax_cfg, initial_capacity=N + 3 * MAX_BATCH)
    coord.bulk_build(list(range(N)), data[:N], max_batch=MAX_BATCH)
    for f in GRAPH_FIELDS:
        rec[f"graph/{f}"] = np.asarray(getattr(coord.arrays, f))
    rec["graph/entry_slot"] = np.int32(coord.entry_slot)
    for name, opts in RECALL_CASES.items():
        ids, _ = coord.search(queries, K, batch_size=1024, **opts)
        rec[f"recall/{name}/ids"] = ids
        rec[f"recall/{name}/hops"] = np.int64(coord.last_search_stats.hops)

    coord.max_insert_batch = MAX_BATCH
    coord.insert(list(range(N, N + 2 * MAX_BATCH)),
                 data[N : N + 2 * MAX_BATCH])
    for f in GRAPH_FIELDS:
        rec[f"insert/graph/{f}"] = np.asarray(getattr(coord.arrays, f))
    q = jnp.asarray(data[N + 2 * MAX_BATCH :])
    for width in (1, 2):
        res = search_for_initial_candidates(
            coord.arrays, q, jnp.int32(coord.entry_slot), params=coord.params,
            l_insert=jax_cfg.l_insert, beam_width=width,
            assume_all_valid=not coord._ever_tombstoned,
        )
        rec[f"insert/w{width}/hops"] = np.asarray(res.hops)
        rec[f"insert/w{width}/visited_count"] = np.asarray(res.visited_count)
    np.savez_compressed(OUT, **rec)
    print(f"wrote {len(rec)} arrays to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
