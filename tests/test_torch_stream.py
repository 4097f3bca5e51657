"""Streaming lane-refill search of the PyTorch port against the JAX
package's ``beam_search_stream``.

Same carried-across graphs and tolerances as tests/test_torch_serving.py.
Ids, distances, per-query visit counts and the hop count equal JAX's
stream; ids, distances and visit counts also equal the port's own
lock-step ``beam_search`` on the same queries (lane packing is a pure
scheduling change).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu.core import searcher as jax_searcher
from duckdb_lm_diskann_tpu_torch.core import searcher
from tests.test_torch_serving import (  # noqa: F401  (graphs: a fixture)
    N,
    assert_same_topk,
    atol_of,
    graphs,
)
from tests.torch_cpu import one_torch_thread  # noqa: F401  (autouse)

ZOMBIES = [7, 40, 41]


@pytest.mark.parametrize("codec,case", [
    ("l2-int4", "lanes<nq"),
    ("cosine-ternary", "lanes<nq"),
    ("l2-int8", "lanes<nq"),
    ("l2-int8", "lanes>nq"),
    ("cosine-ternary", "seeds+allowed"),
    ("l2-int4", "zombies"),
])
def test_stream_matches_jax(graphs, codec, case):
    coord, arrays, params, data, queries = graphs(codec)
    rng = np.random.default_rng(11)
    q = np.concatenate([queries, data[rng.integers(0, N, 25)]])  # NQ = 37
    entry = np.int32(coord.entry_slot)
    allowed = None
    j_arrays = coord.arrays
    lanes = {"lanes<nq": 8, "lanes>nq": 64}.get(case, 4)
    if case == "seeds+allowed":  # per-query seeds [NQ, 3] and a filter
        entry = rng.integers(0, N, (len(q), 3)).astype(np.int32)
        allowed = np.zeros(N, bool)
        allowed[rng.choice(N, 80, replace=False)] = True
    if case == "zombies":  # tombstoned nodes whose in-edges stay
        valid = np.asarray(coord.arrays.valid).copy()
        valid[ZOMBIES] = False
        j_arrays = coord.arrays._replace(valid=jnp.asarray(valid))
        arrays = arrays._replace(valid=torch.from_numpy(valid))
    kw = dict(l_search=24, k=8, assume_all_valid=case != "zombies")
    want = jax_searcher.beam_search_stream(
        j_arrays, jnp.asarray(q), jnp.asarray(entry), params=coord.params,
        lanes=lanes, allowed=None if allowed is None else jnp.asarray(allowed),
        **kw,
    )
    p_allowed = None if allowed is None else torch.from_numpy(allowed)
    got = searcher.beam_search_stream(
        arrays, torch.from_numpy(q), torch.from_numpy(np.array(entry)),
        params=params, lanes=lanes, allowed=p_allowed, **kw,
    )
    assert_same_topk(got, want, atol_of(coord))
    lock = searcher.beam_search(
        arrays, torch.from_numpy(q), torch.from_numpy(np.array(entry)),
        params=params, allowed=p_allowed, **kw,
    )
    assert torch.equal(got.topk_slots, lock.topk_slots)
    assert torch.equal(got.topk_dists, lock.topk_dists)
    assert torch.equal(got.visited_count, lock.visited_count)
    # Packing: total iterations near ceil(total visits / lanes).
    total = int(lock.visited_count.sum())
    assert int(got.hops) <= -(-total // min(lanes, len(q))) + 2 * 24 + 8
    if allowed is not None:
        top = got.topk_slots[got.topk_slots >= 0].numpy()
        assert len(top) and allowed[top].all()
    if case == "zombies":
        assert not np.isin(got.topk_slots.numpy(), ZOMBIES).any()
