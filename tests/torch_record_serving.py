"""Record the JAX package's answers that ``tests/test_torch_serving.py``
holds the port to, into ``tests/golden/torch_serving_jax.npz``.

The serving tests compare the port with the JAX package on the same inputs
(graphs built by the JAX Coordinator from seeded data, then beam search at
E = 2 and 4, ``beam_search_many``, ``pick_adaptive_seeds``, filtered
search and a build at ``insert_beam_width = 2``; and, in
``tests/test_torch_stream.py``, ``beam_search_stream``). Their JAX side is
recorded here once, so the tests themselves run no JAX program: a pytest
worker that has compiled many JAX programs can crash inside XLA's
compile-cache read or write, and the test running there fails with it.
The JAX package is the frozen reference, so the recording stays its
answer.

Run from the repository root (about two minutes on the CPU):

    python tests/torch_record_serving.py
"""

import os
import sys

import numpy as np

OUT = os.path.join(os.path.dirname(__file__), "golden", "torch_serving_jax.npz")

CODECS = ["l2-int4", "cosine-ternary", "l2-int8"]
N, DIMS = 300, 16
_SEARCH_FIELDS = (
    "topk_slots", "topk_dists", "visited_slots", "visited_dists",
    "visited_count", "hops",
)
_MANY_FIELDS = ("topk_slots", "topk_dists", "visited_count", "hops")
GRAPH_FIELDS = (
    "vectors", "neighbors", "valid", "edge_pos", "edge_neg", "edge_i8",
    "edge_i4", "edge_scale", "edge_f32", "dirty_rows",
)


def beam_entry(entry_slot: int, width: int):
    """(entry, max_visits) of test_beam_width_matches_jax's two cases."""
    if width == 2:
        return np.int32(entry_slot), 0
    return np.asarray([entry_slot, 17, 230, 99], np.int32), 30


def per_query_seeds(entry_slot: int) -> np.ndarray:
    per_query = np.random.default_rng(3).integers(0, N, (3, 4, 2)).astype(
        np.int32
    )
    per_query[0, :, 0] = entry_slot
    return per_query


def adaptive_inputs(metric: str):
    rng = np.random.default_rng(0xAD)
    vecs = rng.standard_normal((N, DIMS)).astype(np.float32)
    vecs[3] = vecs[6] = vecs[0]  # exact ties in every query's list
    sample = np.arange(0, N, 3, dtype=np.int32)
    q = np.concatenate([
        rng.standard_normal((10, DIMS)).astype(np.float32), vecs[[0, 9]]
    ])
    return vecs, sample, q


def insert_width_data() -> np.ndarray:
    return np.random.default_rng(0xB2).standard_normal((400, DIMS)).astype(
        np.float32
    )


FILTER_CASES = [(c, 1) for c in CODECS] + [("l2-int4", 2)]

# test_torch_stream.py's cases: (codec, case), and the tombstoned slots of
# its "zombies" case (their in-edges stay).
STREAM_CASES = [
    ("l2-int4", "lanes<nq"),
    ("cosine-ternary", "lanes<nq"),
    ("l2-int8", "lanes<nq"),
    ("l2-int8", "lanes>nq"),
    ("cosine-ternary", "seeds+allowed"),
    ("l2-int4", "zombies"),
]
ZOMBIES = [7, 40, 41]
_GRAPH_SEED = 0x5E7E  # tests/torch_configs.jax_graph's default


def graph_data() -> np.ndarray:
    """The rows every serving graph is built from (jax_graph's first draw
    of its seeded generator)."""
    return np.random.default_rng(_GRAPH_SEED).standard_normal(
        (N, DIMS)
    ).astype(np.float32)


def stream_inputs(case: str, queries, data, entry_slot: int, valid):
    """(q, entry, allowed, valid, lanes) of one stream case."""
    rng = np.random.default_rng(11)
    q = np.concatenate([queries, data[rng.integers(0, N, 25)]])  # NQ = 37
    entry = np.int32(entry_slot)
    allowed = None
    lanes = {"lanes<nq": 8, "lanes>nq": 64}.get(case, 4)
    if case == "seeds+allowed":  # per-query seeds [NQ, 3] and a filter
        entry = rng.integers(0, N, (len(q), 3)).astype(np.int32)
        allowed = np.zeros(N, bool)
        allowed[rng.choice(N, 80, replace=False)] = True
    if case == "zombies":
        valid = valid.copy()
        valid[ZOMBIES] = False
    return q, entry, allowed, valid, lanes


def filter_mask() -> np.ndarray:
    allowed = np.zeros(N, bool)
    allowed[::3] = True
    return allowed


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from duckdb_lm_diskann_tpu.core import searcher as jax_searcher
    from duckdb_lm_diskann_tpu.core.coordinator import (
        Coordinator as JaxCoordinator,
    )
    from tests.torch_configs import configs, jax_graph, metrics

    rec = {}
    graphs = {}
    for name in CODECS:
        coord, _, data, queries = jax_graph(*name.split("-"), n=N, dims=DIMS)
        assert np.array_equal(data, graph_data())
        graphs[name] = coord
        for f in GRAPH_FIELDS:
            rec[f"graph/{name}/{f}"] = np.asarray(getattr(coord.arrays, f))
        rec[f"graph/{name}/entry_slot"] = np.int32(coord.entry_slot)
        rec[f"graph/{name}/queries"] = queries

        for width in (2, 4):
            entry, max_visits = beam_entry(coord.entry_slot, width)
            res = jax_searcher.beam_search(
                coord.arrays, jnp.asarray(queries), jnp.asarray(entry),
                params=coord.params, l_search=32, k=10,
                max_visits=max_visits, beam_width=width,
                assume_all_valid=True,
            )
            for f in _SEARCH_FIELDS:
                rec[f"beam/{name}/{width}/{f}"] = np.asarray(getattr(res, f))

        qs = queries.reshape(3, 4, DIMS)
        for i, entry in enumerate(
            (np.int32(coord.entry_slot), per_query_seeds(coord.entry_slot))
        ):
            res = jax_searcher.beam_search_many(
                coord.arrays, jnp.asarray(qs), jnp.asarray(entry),
                params=coord.params, l_search=24, k=5, assume_all_valid=True,
            )
            for f in _MANY_FIELDS:
                rec[f"many/{name}/{i}/{f}"] = np.asarray(getattr(res, f))

    for name, case in STREAM_CASES:
        coord = graphs[name]
        q, entry, allowed, valid, lanes = stream_inputs(
            case, rec[f"graph/{name}/queries"], graph_data(),
            coord.entry_slot, np.asarray(coord.arrays.valid),
        )
        res = jax_searcher.beam_search_stream(
            coord.arrays._replace(valid=jnp.asarray(valid)), jnp.asarray(q),
            jnp.asarray(entry), params=coord.params, lanes=lanes,
            allowed=None if allowed is None else jnp.asarray(allowed),
            l_search=24, k=8, assume_all_valid=case != "zombies",
        )
        for f in _MANY_FIELDS:
            rec[f"stream/{name}/{case}/{f}"] = np.asarray(getattr(res, f))

    for name, width in FILTER_CASES:
        coord = graphs[name]
        queries = rec[f"graph/{name}/queries"]
        res = jax_searcher.beam_search(
            coord.arrays, jnp.asarray(queries), jnp.int32(coord.entry_slot),
            params=coord.params, allowed=jnp.asarray(filter_mask()),
            l_search=32, k=10, beam_width=width, assume_all_valid=True,
        )
        for f in _SEARCH_FIELDS:
            rec[f"filter/{name}/{width}/{f}"] = np.asarray(getattr(res, f))

    for metric in ("l2", "cosine"):
        jmetric, _ = metrics(metric)
        vecs, sample, q = adaptive_inputs(metric)
        for s_count in (1, 3):
            rec[f"adaptive/{metric}/{s_count}"] = np.asarray(
                jax_searcher.pick_adaptive_seeds(
                    jnp.asarray(vecs), jnp.asarray(q), jnp.asarray(sample),
                    metric=jmetric, s_count=s_count,
                )
            )

    data = insert_width_data()
    jax_cfg, _ = configs(dims=DIMS, insert_beam_width=2)
    jc = JaxCoordinator(jax_cfg, initial_capacity=len(data))
    jc.bulk_build(range(len(data)), data, max_batch=64)
    rec["insert_width/neighbors"] = np.asarray(jc.arrays.neighbors)
    rec["insert_width/search_ids"] = jc.search(data[:6] + 0.05, 5)[0]

    np.savez_compressed(OUT, **rec)
    print(f"wrote {len(rec)} arrays to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
