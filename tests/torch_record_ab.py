"""Record the JAX package's answers that ``tests/test_torch_ab_experiments.py``
holds the port's A/B experiments to, into ``tests/golden/torch_ab_jax.npz``.

Each script of ``benchmarks/`` is replayed here the way it calls the JAX
package, with the same options the port's test passes to its twin under
``duckdb_lm_diskann_tpu_torch/experiments/``, at a small size: N = 512
rows of D = 16, the graph options scaled by 1/8 (R = 8, L_insert = 16; the
R = 96 arm R = 12, L_insert = 24) and the search L by 1/3.125 (100 -> 32):

  * ``insert_width/``: ``ab_insert_width.py``: ``make_corpus`` rows, a
    build at each insert beam width, ``beam_search`` (``assume_all_valid``)
    at each serving width over batches of B: top-k rowids (the slots
    through the Coordinator's slot -> rowid table), distances and hops per
    batch; the exact top-k (``all_pairs_distance`` + ``lax.top_k``);
  * ``width_iso/``: ``ab_width_iso.py``: W x L through
    ``beam_search_many`` on a FLOAT32-node build, W = 1 on an INT8-node
    build of the same float rows (its stored int8 table too); the strict
    ``argpartition`` top-k;
  * ``hard_build/``: ``ab_hard_build.py``: ``make_hard_corpus`` rows, each
    build configuration (``refine()`` where it says so), then
    ``Coordinator.search`` with adaptive seeds at each L: rowids,
    distances, hops; the chunked ``argpartition`` top-k.

Recorded once, as ``tests/torch_record_instruments.py`` does, so that the
port's tests run no JAX program in their pytest workers. Run from the
repository root (a few minutes on the CPU):

    python tests/torch_record_ab.py
"""

import os
import sys

import numpy as np

OUT = os.path.join(os.path.dirname(__file__), "golden", "torch_ab_jax.npz")

N, DIMS, NQ, K, B, MAX_BATCH = 512, 16, 64, 10, 32, 64
R, L_INSERT, ALPHA = 8, 16, 1.2
# ab_insert_width: insert width x serving width at L = 100 -> 32.
INSERT_WIDTHS = SERVE_WIDTHS = (1, 2, 4)
INSERT_L = 32
# ab_width_iso: W x L in {50, 75, 100} -> {16, 24, 32}; INT8 L {50, 100}.
ISO_WIDTHS, ISO_LS, ISO_INT8_LS = (1, 2, 4), (16, 24, 32), (16, 32)
# ab_hard_build: the five configurations at 1/8 of R and L_insert, searched
# at L in {100, 150, 200} -> {16, 24, 32}.
HARD_CONFIGS = {
    "base": (8, 16, 1.2, False),
    "refine": (8, 16, 1.2, True),
    "r96": (12, 24, 1.2, False),
    "r96refine": (12, 24, 1.2, True),
    "a13refine": (8, 16, 1.3, True),
}
HARD_LS = (16, 24, 32)
HARD_SEARCH = {"adaptive_seeds": 2, "seed_sample": 4096, "batch_size": 1000}


def manifold_case():
    """(rows [N, DIMS], queries [NQ, DIMS]): ``make_corpus`` rows and
    queries near them, as ``ab_insert_width`` and ``ab_width_iso`` draw
    them."""
    from duckdb_lm_diskann_tpu_torch.experiments.ab_insert_width import corpus

    return corpus(N, NQ, dims=DIMS)


def hard_case():
    """(rows, queries) of ``ab_hard_build``'s HARD corpus at N x DIMS."""
    from duckdb_lm_diskann_tpu_torch.experiments.ab_hard_build import corpus

    return corpus(N, NQ, dims=DIMS)


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")

    from duckdb_lm_diskann_tpu.common.types import (
        EdgeType,
        MetricType,
        VectorType,
    )
    from duckdb_lm_diskann_tpu.core.config import LmDiskannConfig
    from duckdb_lm_diskann_tpu.core.coordinator import Coordinator
    from duckdb_lm_diskann_tpu.core.searcher import (
        beam_search,
        beam_search_many,
    )
    from duckdb_lm_diskann_tpu.ops.distance import all_pairs_distance

    def jax_config(r=R, l_insert=L_INSERT, alpha=ALPHA, node_type="float32",
                   insert_beam_width=1):
        cfg = LmDiskannConfig(
            metric_type=MetricType.L2, r=r, l_insert=l_insert, alpha=alpha,
            l_search=100, dimensions=DIMS,
            node_vector_type=VectorType(node_type), edge_type=EdgeType.INT4,
            insert_beam_width=insert_beam_width,
        )
        cfg.validate()
        return cfg

    def built(cfg, data):
        coord = Coordinator(cfg, initial_capacity=N)
        coord.bulk_build(list(range(N)), data, max_batch=MAX_BATCH)
        return coord

    def rowids(coord, slots):
        slots = np.asarray(slots)
        table = coord.capture_view().slot_rowids
        return np.where(slots >= 0, table[np.maximum(slots, 0)], -1)

    rec = {}
    data, queries = manifold_case()
    q_dev = jnp.asarray(queries)
    dist = all_pairs_distance(q_dev, jnp.asarray(data), MetricType.L2)
    rec["insert_width/truth"] = np.asarray(jax.lax.top_k(-dist, K)[1])
    for w_ins in INSERT_WIDTHS:
        coord = built(jax_config(insert_beam_width=w_ins), data)
        for w_srv in SERVE_WIDTHS:
            outs = [beam_search(
                coord.arrays, q_dev[i * B : (i + 1) * B],
                jnp.int32(coord.entry_slot), params=coord.params,
                l_search=INSERT_L, k=K, beam_width=w_srv,
                assume_all_valid=True,
            ) for i in range(NQ // B)]
            key = f"insert_width/{w_ins}/{w_srv}"
            rec[f"{key}/ids"] = rowids(coord, np.concatenate(
                [np.asarray(o.topk_slots) for o in outs]))
            rec[f"{key}/dists"] = np.concatenate(
                [np.asarray(o.topk_dists) for o in outs])
            rec[f"{key}/hops"] = np.asarray([int(o.hops) for o in outs])

    d = np.asarray(dist)
    rec["width_iso/truth"] = np.argpartition(d, K, axis=1)[:, :K]
    qs = q_dev.reshape(NQ // B, B, DIMS)
    for node_t, grid in (
        ("float32", [(w, L) for w in ISO_WIDTHS for L in ISO_LS]),
        ("int8", [(1, L) for L in ISO_INT8_LS]),
    ):
        coord = built(jax_config(node_type=node_t), data)
        if node_t == "int8":
            rec["width_iso/int8/vectors"] = np.asarray(coord.arrays.vectors)
        for width, L in grid:
            res = beam_search_many(
                coord.arrays, qs, jnp.int32(coord.entry_slot),
                params=coord.params, l_search=L, k=K, beam_width=width,
                assume_all_valid=True,
            )
            key = f"width_iso/{node_t}/{width}/{L}"
            rec[f"{key}/ids"] = rowids(
                coord, np.asarray(res.topk_slots).reshape(NQ, K))
            rec[f"{key}/dists"] = np.asarray(res.topk_dists).reshape(NQ, K)
            rec[f"{key}/hops"] = np.asarray(res.hops)

    data, queries = hard_case()
    d = np.asarray(all_pairs_distance(jnp.asarray(queries),
                                      jnp.asarray(data), MetricType.L2))
    ii = np.argpartition(d, K, axis=1)[:, :K]
    order = np.argsort(np.take_along_axis(d, ii, axis=1), axis=1)
    rec["hard_build/truth"] = np.take_along_axis(ii, order, axis=1)
    for name, (r, l_insert, alpha, do_refine) in HARD_CONFIGS.items():
        coord = built(jax_config(r=r, l_insert=l_insert, alpha=alpha), data)
        if do_refine:
            coord.refine()
        for L in HARD_LS:
            ids, dists = coord.search(queries, K, l_search=L, **HARD_SEARCH)
            key = f"hard_build/{name}/{L}"
            rec[f"{key}/ids"] = ids
            rec[f"{key}/dists"] = dists
            rec[f"{key}/hops"] = np.int64(coord.last_search_stats.hops)
    np.savez_compressed(OUT, **rec)
    print(f"wrote {len(rec)} arrays to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
