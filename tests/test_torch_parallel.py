"""The port's sharded engines (``parallel/``) on CPU meshes.

Disjoint shards (the cases of ``tests/test_sharded.py``): the round-robin
partition, search == the merge of every shard's own search, insert /
delete / update, a mutation that leaves the other shards' tensors as they
were, and one case held to the JAX package's ``ShardedIndex`` on its
8-device CPU mesh (ids equal; the JAX side is recorded by
``tests/torch_record_parallel.py``, so this file runs no JAX program).

One global graph over row blocks (the cases of
``tests/test_global_sharded.py``): search, ``distributed_build`` and
delete / vacuum / update give the single port ``Coordinator``'s answers
and tables bit for bit, for (l2, INT4), (cosine, TERNARY) and (l2, INT8)
at S = 4 (and the four codecs without a kernel), with an insert past the
capacity that re-splits the blocks; one tiny case against the JAX
package's ``GlobalShardedIndex`` (through ``GlobalShardedIndex.search``
and the bare ``global_sharded_search``).

Persistence of both modes, the entry fallback of a row-sharded load, and
inserts into a row-sharded load (as into ``load_index``'s).
The card's case (the frontier kernels launch once per row block) carries
the ``cuda`` marker.
"""

import types

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.core.builder import inlink_histogram
from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu_torch.core.graph import graph_arrays_from_numpy
from duckdb_lm_diskann_tpu_torch.parallel import global_graph, mesh, sharded
from duckdb_lm_diskann_tpu_torch.parallel.global_graph import (
    GlobalShardedIndex,
    load_global_sharded,
)
from duckdb_lm_diskann_tpu_torch.parallel.sharded import (
    ShardedIndex,
    load_sharded,
    partition_rows,
)
from tests import torch_record_parallel as rec
from tests.torch_configs import configs
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)

DIMS, N, S = 16, 320, 4
CODECS = [("l2", "int4"), ("cosine", "ternary"), ("l2", "int8")]
# The codecs without a kernel read their row-sharded tables by gathers.
PLAIN_CODECS = [
    ("cosine", "float32"), ("cosine", "float16"), ("cosine", "none"),
    ("cosine", "float1bit"),
]


def cpu_mesh(n=S):
    return mesh.make_mesh("cpu", n)


def data_and_queries(seed=0x9A2, n=N, dims=DIMS, nq=12):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, dims)).astype(np.float32)
    q = data[rng.integers(0, n, nq)] + 0.05 * rng.standard_normal(
        (nq, dims)
    ).astype(np.float32)
    return data, q.astype(np.float32)


def assert_same_tables(a, b):
    """Every table of two GraphArrays equal over their common rows, the
    rows past it empty (row-sharded capacities are padded)."""
    for name in a._fields:
        x, y = getattr(a, name).cpu(), getattr(b, name).cpu()
        m = min(x.shape[0], y.shape[0])
        assert torch.equal(x[:m], y[:m]), name
        for t in (x[m:], y[m:]):
            fill = -1 if name == "neighbors" else 0
            assert bool((t == fill).all()), name


def port_cfg(metric="l2", edge="int4", **kw):
    return configs(metric=metric, edge_type=edge, dims=DIMS, **kw)[1]


# ---------------------------------------------------------------- mesh


def test_make_mesh_explicit_and_refusing():
    assert mesh.make_mesh("cpu", 3) == [torch.device("cpu")] * 3
    assert mesh.make_mesh(["cpu", "cpu"], n=1) == [torch.device("cpu")]
    with pytest.raises(ValueError):
        mesh.make_mesh(["cpu"], n=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mesh.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedIndex(port_cfg())  # no silent CPU fallback
    pm = mesh.ProcessMesh(["cpu", "cpu"], rank=1, world_size=2)
    assert pm.n_shards == 4 and pm.local_shards == [2, 3]


def test_partition_round_robin():
    parts = partition_rows(10, 4)
    assert [p.tolist() for p in parts] == [
        [0, 4, 8], [1, 5, 9], [2, 6], [3, 7]]


# ------------------------------------------------------- disjoint shards


@pytest.fixture(scope="module")
def disjoint():
    data, q = data_and_queries()
    idx = ShardedIndex(port_cfg(), mesh=cpu_mesh())
    idx.build(np.arange(N), data, max_batch=64)
    return idx, data, q


def merged_shard_answers(idx, q, k):
    """The merge of every shard's own Coordinator.search, by (dist, id)."""
    per = [c.search(q, k) for c in idx.coordinators]
    ids = np.concatenate([i for i, _ in per], 1)
    dists = np.concatenate([d for _, d in per], 1)
    order = np.stack([np.lexsort((ids[b], dists[b]))[:k] for b in range(len(q))])
    return (
        np.take_along_axis(ids, order, 1), np.take_along_axis(dists, order, 1)
    )


def test_disjoint_search_is_the_merge_of_the_shards(disjoint):
    idx, data, q = disjoint
    assert [c.count for c in idx.coordinators] == [N // S] * S
    for c, part in zip(idx.coordinators, partition_rows(N, S)):
        assert sorted(c.allocator.rowid_to_slot) == part.tolist()
    ids, dists = idx.search(q, 10)
    want_ids, want_d = merged_shard_answers(idx, q, 10)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(dists, want_d)
    d2 = ((q[:, None, :] - data[None]) ** 2).sum(-1)
    truth = np.argsort(d2, 1, kind="stable")[:, :10]
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, truth)])
    assert recall >= 0.9, recall


def test_disjoint_insert_delete_update():
    data, q = data_and_queries(seed=0x51)
    idx = ShardedIndex(port_cfg(), mesh=cpu_mesh())
    idx.build(np.arange(200), data[:200], max_batch=64)
    # New rows go to the smallest shards first.
    idx.coordinators[1].delete([1, 5, 9])
    idx.insert([9000, 9001], data[200:202])
    assert idx.coordinators[1].allocator.rowid_to_slot.keys() >= {9000}
    v = data[250] + 0.001
    idx.insert([9999], v[None])
    assert idx.search(v[None], 1)[0][0, 0] == 9999
    assert idx.delete([9999, 123456]) == 1
    assert idx.search(v[None], 1)[0][0, 0] != 9999
    idx.update(9000, v)
    assert idx.search(v[None], 1)[0][0, 0] == 9000
    assert idx.count == 200 - 3 + 2
    ids, dists = idx.search(q, 5)
    want_ids, want_d = merged_shard_answers(idx, q, 5)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(dists, want_d)


def test_mutating_one_shard_leaves_the_others_untouched():
    """The port keeps every shard resident: a delete and an insert on one
    shard touch no tensor of another (same storage, same bytes)."""
    data, _ = data_and_queries(seed=0x77)
    idx = ShardedIndex(port_cfg(), mesh=cpu_mesh())
    idx.build(np.arange(160), data[:160], max_batch=64)
    before = [
        [(t.data_ptr(), t.clone()) for t in c.arrays] for c in idx.coordinators
    ]
    row0 = partition_rows(160, S)[2][0]
    assert idx.delete([int(row0)]) == 1  # lives on shard 2
    idx.coordinators[2].insert([5000], data[200:201])
    for s, c in enumerate(idx.coordinators):
        if s == 2:
            continue
        for (ptr, copy), t in zip(before[s], c.arrays):
            assert t.data_ptr() == ptr and torch.equal(t, copy)


def test_sharded_insert_step_runs_each_shard():
    data, _ = data_and_queries(seed=0x3C)
    idx = ShardedIndex(port_cfg(), mesh=cpu_mesh(2))
    idx.build(np.arange(64), data[:64], max_batch=16)
    base = [c.allocator.high_water for c in idx.coordinators]
    slots = [torch.arange(b, b + 4, dtype=torch.int32) for b in base]
    vecs = [torch.from_numpy(data[64 + 4 * s : 68 + 4 * s]) for s in range(2)]
    out = sharded.sharded_insert_step(
        [c.arrays for c in idx.coordinators], slots, vecs,
        [c.entry_slot for c in idx.coordinators], params=idx.params,
    )
    for a, b in zip(out, base):
        assert bool(a.valid[b : b + 4].all())
        assert bool((a.neighbors[b : b + 4] >= 0).any(-1).all())


@pytest.fixture(scope="module")
def jax_answers():
    """The JAX package's sharded answers, recorded by
    ``tests/torch_record_parallel.py`` (this file runs no JAX program)."""
    with np.load(rec.OUT) as f:
        return {k: f[k] for k in f.files}


def test_disjoint_matches_jax(jax_answers):
    """The port's ShardedIndex over eight CPU shards, 800 x 16, against the
    JAX package's over its 8-device CPU mesh, built from the same rows:
    ids equal, distances to rtol 1e-5."""
    data, q = rec.data_and_queries(**rec.DISJOINT)
    _, p_cfg = configs(metric="l2", edge_type="int4", dims=DIMS, l_search=48)
    pidx = ShardedIndex(p_cfg, mesh=cpu_mesh(8))
    pidx.build(np.arange(len(data)), data, max_batch=128)
    ids, dists = pidx.search(q, 10)
    np.testing.assert_array_equal(ids, jax_answers["disjoint/ids"])
    np.testing.assert_allclose(dists, jax_answers["disjoint/dists"], rtol=1e-5)


# -------------------------------------------------- one global graph


@pytest.mark.parametrize("metric,edge", CODECS + PLAIN_CODECS)
def test_global_search_build_and_dml_equal_one_coordinator(metric, edge):
    """Row blocks over four CPU shards: the replicated graph's search, the
    distributed build's tables and entry, and the tables after the same
    delete, vacuum, insert and update equal the single Coordinator's; so
    do the answers and hops after them."""
    data, q = data_and_queries()
    cfg = port_cfg(metric, edge)
    one = Coordinator(cfg, device="cpu")
    one.bulk_build(range(N), data, max_batch=64)
    want = one.search(q, 10)
    hops = one.last_search_stats.hops
    rep = GlobalShardedIndex(one, mesh=cpu_mesh())
    got = rep.search(q, 10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert rep.last_search_stats.hops == hops
    blocks = rep.distribute().vectors.blocks
    assert len(blocks) == S and all(b.shape[0] == one.capacity // S for b in blocks)

    g = GlobalShardedIndex(Coordinator(cfg, device="cpu"), mesh=cpu_mesh())
    g.distributed_build(range(N), data, max_batch=64, capacity=N + 16)
    assert g.coordinator.capacity == N + 16
    assert_same_tables(one.arrays, g.coordinator.arrays)
    assert (g.coordinator.entry_slot, g.coordinator.entry_rowid) == (
        one.entry_slot, one.entry_rowid
    )
    got = g.search(q, 10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])

    dels = list(range(0, N, 7)) + [one.entry_rowid]
    assert g.delete(dels) == one.delete(dels)
    assert_same_tables(one.arrays, g.coordinator.arrays)
    assert g.coordinator.entry_slot == one.entry_slot  # the fallback
    assert g.vacuum() == one.vacuum()
    assert_same_tables(one.arrays, g.coordinator.arrays)
    assert g.coordinator.last_relinked == one.last_relinked
    new = data[:3] + 0.25
    g.insert([7000, 7001, 7002], new)
    one.insert([7000, 7001, 7002], new)
    g.update(7001, data[5] - 0.1)
    one.update(7001, data[5] - 0.1)
    assert_same_tables(one.arrays, g.coordinator.arrays)
    want = one.search(q, 10, batch_size=4)
    got = g.search(q, 10, batch_size=4)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # An insert past the capacity re-splits the blocks at twice the height.
    more = data[:100] - 0.3
    g.insert(range(10000, 10100), more)
    one.insert(range(10000, 10100), more)
    assert g.coordinator.capacity == 2 * (N + 16)
    assert all(
        b.shape[0] == 2 * (N + 16) // S for b in g.coordinator.arrays.vectors.blocks
    )
    assert_same_tables(one.arrays, g.coordinator.arrays)
    got, want = g.search(q, 10), one.search(q, 10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_row_blocks_gather_write_and_histogram():
    """The row-sharded table against the plain one: gathers of any index
    shape, element gathers, row ranges, writes, the in-link histogram and
    a kernel wrapper run per block (non-owned rows clamped)."""
    from duckdb_lm_diskann_tpu_torch.common.types import MetricType
    from duckdb_lm_diskann_tpu_torch.core.searcher import _frontier_scores
    from duckdb_lm_diskann_tpu_torch.kernels.int4_frontier import (
        int4_frontier_scores,
    )

    g = torch.Generator().manual_seed(5)
    C, R, DW = 24, 4, 2
    plain = {
        "codes": torch.randint(-2**31, 2**31 - 1, (C, R, DW), generator=g, dtype=torch.int32),
        "scale": torch.rand((C, R), generator=g),
        "nbrs": torch.randint(-1, C, (C, R), generator=g, dtype=torch.int32),
        "valid": torch.rand(C, generator=g) > 0.2,
    }
    sharded_t = {
        k: global_graph.RowShardedTable(
            [b.clone() for b in global_graph._stack_rows(v, 3)], C // 3, "cpu"
        )
        for k, v in plain.items()
    }
    idx = torch.randint(0, C, (5, 7), generator=g)
    for k in plain:
        assert torch.equal(sharded_t[k][idx], plain[k][idx])
        assert torch.equal(sharded_t[k][3:19], plain[k][3:19])
        assert torch.equal(sharded_t[k].cpu(), plain[k])
    cols = torch.randint(0, R, (9,), generator=g)
    rows = torch.randint(0, C, (9,), generator=g)
    assert torch.equal(sharded_t["codes"][rows, cols], plain["codes"][rows, cols])
    assert torch.equal(
        inlink_histogram(sharded_t["nbrs"], sharded_t["valid"], C),
        inlink_histogram(plain["nbrs"], plain["valid"], C),
    )
    cur = torch.randint(0, C, (6,), generator=g, dtype=torch.int32)
    q = torch.randn((6, 16), generator=g)
    got = _frontier_scores(
        int4_frontier_scores, cur, (q,), (sharded_t["codes"], sharded_t["scale"]),
        metric=MetricType.L2,
    )
    want = int4_frontier_scores(cur, q, plain["codes"], plain["scale"], metric=MetricType.L2)
    assert torch.equal(got, want)
    tgt = torch.tensor([2, 9, 23, 15])
    val = torch.randint(-1, C, (4, R), generator=g, dtype=torch.int32)
    plain["nbrs"][tgt] = val
    sharded_t["nbrs"][tgt] = val
    plain["nbrs"][tgt, torch.tensor([0, 1, 2, 3])] = 7
    sharded_t["nbrs"][tgt, torch.tensor([0, 1, 2, 3])] = 7
    assert torch.equal(sharded_t["nbrs"].cpu(), plain["nbrs"])


def test_global_matches_jax(jax_answers):
    """The port's row-sharded search of a graph carried across from the
    JAX package equals the JAX package's GlobalShardedIndex over four
    devices (ids, and distances to rtol 1e-5)."""
    _, q = rec.data_and_queries(**rec.GLOBAL)
    _, p_cfg = configs(metric="l2", edge_type="int4", dims=DIMS)
    graph = {f: jax_answers[f"global/graph/{f}"] for f in rec.GRAPH_FIELDS}
    slot_rowids = jax_answers["global/slot_rowids"]
    live = np.nonzero(slot_rowids >= 0)[0]
    pc = Coordinator(p_cfg, initial_capacity=len(slot_rowids), device="cpu")
    pc.arrays = graph_arrays_from_numpy(types.SimpleNamespace(**graph), "cpu")
    pc.allocator.rowid_to_slot = {int(slot_rowids[s]): int(s) for s in live}
    pc.allocator.slot_to_rowid = {int(s): int(slot_rowids[s]) for s in live}
    pc.allocator.high_water = int(live.max()) + 1
    pc._slot_rowids = slot_rowids.copy()
    pc.entry_slot = int(jax_answers["global/entry_slot"])
    pc.entry_rowid = int(slot_rowids[pc.entry_slot])
    gi = GlobalShardedIndex(pc, mesh=cpu_mesh())
    got = gi.search(q, 5, l_search=32)
    np.testing.assert_array_equal(got[0], jax_answers["global/ids"])
    np.testing.assert_allclose(got[1], jax_answers["global/dists"], rtol=1e-5)
    # The bare search over the row blocks, as the JAX package's
    # global_sharded_search: slots, mapped to row ids here.
    slots, dists = global_graph.global_sharded_search(
        gi.distribute(), torch.from_numpy(q), pc.entry_slot,
        params=pc.params, l_search=32, k=5,
    )
    slots = slots.numpy()
    ids = np.where(slots >= 0, slot_rowids[np.maximum(slots, 0)], -1)
    np.testing.assert_array_equal(ids, jax_answers["global/ids"])
    np.testing.assert_array_equal(dists.numpy(), got[1])


# ---------------------------------------------------------- persistence


def test_disjoint_persistence_roundtrip(disjoint, tmp_path):
    idx, _, q = disjoint
    info = idx.save(tmp_path / "sh")
    assert info["n_shards"] == S
    back = load_sharded(tmp_path / "sh", mesh=cpu_mesh())
    for a, b in zip(idx.coordinators, back.coordinators):
        assert_same_tables(a.arrays, b.arrays)
    np.testing.assert_array_equal(back.search(q, 10)[0], idx.search(q, 10)[0])
    with pytest.raises(ValueError, match="shards"):
        load_sharded(tmp_path / "sh", mesh=cpu_mesh(2))


def test_global_persistence_roundtrip_and_entry_fallback(tmp_path):
    from duckdb_lm_diskann_tpu_torch.store.checkpoint import load_index
    from duckdb_lm_diskann_tpu_torch.store.shadow import ShadowStorageService

    data, q = data_and_queries(seed=0x99)
    cfg = port_cfg("cosine", "ternary")
    g = GlobalShardedIndex(Coordinator(cfg, device="cpu"), mesh=cpu_mesh())
    g.distributed_build(range(N), data, max_batch=64)
    g.delete(list(range(0, N, 11)))
    want = g.search(q, 10)
    g.save(tmp_path / "g")
    back = load_global_sharded(tmp_path / "g", mesh=cpu_mesh(), device="cpu")
    assert back.n_shards == S and back.coordinator.count == g.coordinator.count
    got = back.search(q, 10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # The same directory opens on one device with the same tables...
    one = load_index(tmp_path / "g", device="cpu")
    assert_same_tables(one.arrays, back.coordinator.arrays)
    # ...and with its entry row gone both loaders pick the same fallback.
    shadow = ShadowStorageService(tmp_path / "g")
    shadow.set_metadata("entry_rowid", 0)  # deleted above
    shadow.close()
    one = load_index(tmp_path / "g", device="cpu")
    back = load_global_sharded(tmp_path / "g", mesh=cpu_mesh(3), device="cpu")
    assert back.coordinator.entry_slot == one.entry_slot >= 0
    assert back.coordinator.entry_rowid == one.entry_rowid != 0


def test_global_load_takes_inserts_like_load_index(tmp_path):
    """A row-sharded load has load_index's room (max(1024, rows), rounded
    up to a multiple of S) and grows past it: inserts into it give
    load_index's tables and answers after the same inserts."""
    from duckdb_lm_diskann_tpu_torch.store.checkpoint import load_index

    data, q = data_and_queries(seed=0x5A, n=N + 40)
    cfg = port_cfg("l2", "int8")
    g = GlobalShardedIndex(Coordinator(cfg, device="cpu"), mesh=cpu_mesh())
    g.distributed_build(range(N), data[:N], max_batch=64)
    assert g.coordinator.capacity == N
    g.save(tmp_path / "g")
    back = load_global_sharded(tmp_path / "g", mesh=cpu_mesh(3), device="cpu")
    one = load_index(tmp_path / "g", device="cpu")
    assert back.coordinator.capacity == 1026 and one.capacity >= 1024
    back.insert(range(N, N + 40), data[N:])
    one.insert(range(N, N + 40), data[N:])
    assert_same_tables(one.arrays, back.coordinator.arrays)
    extra = np.repeat(data[:1], 1100, 0) + np.linspace(0, 1, 1100, dtype=np.float32)[:, None]
    back.insert(range(5000, 6100), extra)
    one.insert(range(5000, 6100), extra)
    assert back.coordinator.capacity == 2052
    assert_same_tables(one.arrays, back.coordinator.arrays)
    got, want = back.search(q, 10), one.search(q, 10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------- card


@pytest.mark.cuda
def test_global_search_launches_kernels_per_block_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier

    data, q = data_and_queries()
    one = Coordinator(port_cfg(), device="cuda")
    one.bulk_build(range(N), data, max_batch=64)
    want = one.search(q, 10)
    g = GlobalShardedIndex(one, mesh=mesh.make_mesh("cuda", 4))
    g.distribute()
    int4_frontier.LAUNCHES = 0
    got = g.search(q, 10)
    # one launch a row block a hop (hops counts the hops with a live lane)
    assert int4_frontier.LAUNCHES % 4 == 0
    assert int4_frontier.LAUNCHES >= 4 * g.last_search_stats.hops > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
