"""Streaming lane-refill search of the PyTorch port against the JAX
package's ``beam_search_stream``.

Same carried-across graphs and tolerances as tests/test_torch_serving.py,
and, as there, the JAX answers are recorded (``tests/torch_record_serving.py``),
so this file runs no JAX program. Ids, distances, per-query visit counts
and the hop count equal JAX's stream; ids, distances and visit counts also
equal the port's own lock-step ``beam_search`` on the same queries (lane
packing is a pure scheduling change).
"""

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.core import searcher
from tests import torch_record_serving as rec
from tests.test_torch_serving import (  # noqa: F401  (fixtures)
    assert_same_topk,
    atol_of,
    graphs,
    jax_answers,
    recorded,
)
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)

ZOMBIES = rec.ZOMBIES


@pytest.mark.parametrize("codec,case", rec.STREAM_CASES)
def test_stream_matches_jax(graphs, jax_answers, codec, case):
    coord, arrays, params, data, queries = graphs(codec)
    q, entry, allowed, valid, lanes = rec.stream_inputs(
        case, queries, data, coord.entry_slot, arrays.valid.numpy()
    )
    if case == "zombies":  # tombstoned nodes whose in-edges stay
        arrays = arrays._replace(valid=torch.from_numpy(valid))
    kw = dict(l_search=24, k=8, assume_all_valid=case != "zombies")
    want = recorded(jax_answers, f"stream/{codec}/{case}", rec._MANY_FIELDS)
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
