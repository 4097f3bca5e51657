"""The index lifecycle of the PyTorch port against the JAX package: delete
(sequential and batched), orphan rescue, vacuum's slot order, update,
reachability repair, refine, the entry fallback, commit drop and the
in-memory size, on shared numpy inputs on the CPU.

Each JAX graph is built once per process and copied for every test that
mutates it; the port gets the same state carried across
(``port_coordinator_from_jax``). After the same steps on both sides every
graph table, the entry point, the allocator and the flags are identical
(``assert_same_state``): no f32 tie has flipped on these shapes. The
``cuda`` test holds the lifecycle on the card against the same steps on
the CPU; it skips without a card.
"""

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.core import builder as port_builder
from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu_torch.core.graph import GraphParams
from duckdb_lm_diskann_tpu_torch.ops.distance import pairwise_distance
from duckdb_lm_diskann_tpu_torch.utils.verify import verify_graph
from tests.torch_configs import (
    assert_same_state,
    configs,
    jax_coordinator_copy,
    port_coordinator_from_jax,
)
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)

N, DIMS = 400, 16
# (metric, codec) of the shared graphs: the headline's codec and the
# cosine default.
GRAPHS = {"int4": ("l2", "int4"), "ternary": ("cosine", "ternary")}
OPTS = dict(dims=DIMS, r=8, l_insert=16, l_search=32)
_BUILT: dict = {}


def _data(seed=0x11FE):
    return np.random.default_rng(seed).standard_normal((N, DIMS)).astype(
        np.float32
    )


def pair(kind):
    """(JAX Coordinator, port Coordinator) holding the same bulk-built
    graph; fresh copies on every call."""
    from duckdb_lm_diskann_tpu.core.coordinator import (
        Coordinator as JaxCoordinator,
    )

    metric, codec = GRAPHS[kind]
    jax_cfg, port_cfg = configs(metric=metric, edge_type=codec, **OPTS)
    if kind not in _BUILT:
        jc = JaxCoordinator(jax_cfg, initial_capacity=N)
        jc.bulk_build(list(range(N)), _data(), max_batch=64)
        _BUILT[kind] = jc
    jc = jax_coordinator_copy(_BUILT[kind])
    return jc, port_coordinator_from_jax(jc, port_cfg)


def _same_search(jc, pc, queries, k=5, **opts):
    want_ids, want_d = jc.search(queries, k, **opts)
    got_ids, got_d = pc.search(queries, k, **opts)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-6)
    assert pc.last_search_stats.hops == jc.last_search_stats.hops
    return got_ids


@pytest.mark.parametrize("mode", ["batched", "sequential"])
@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_delete_matches_jax(kind, mode):
    jc, pc = pair(kind)
    victims = np.random.default_rng(5).choice(N, 40, replace=False).tolist()
    victims += [victims[0], 10_000]  # a repeat and a missing row: skipped
    if mode == "batched":
        assert pc.delete(victims) == jc.delete(victims) == 40
    else:
        for v in victims:
            assert pc.delete([v]) == jc.delete([v])
    assert_same_state(jc, pc)
    assert pc._ever_tombstoned
    queries = _data()[:12] + 0.01
    ids = _same_search(jc, pc, queries)
    assert not np.isin(ids, victims).any()


def test_delete_of_missing_rows_is_a_no_op():
    jc, pc = pair("int4")
    assert pc.delete([10_000, -5]) == 0 == jc.delete([10_000, -5])
    assert not pc._ever_tombstoned
    assert_same_state(jc, pc)


def test_entry_point_fallback_on_delete():
    jc, pc = pair("ternary")
    entry = pc.entry_rowid
    jc.delete([entry])
    pc.delete([entry])
    assert pc.entry_rowid != entry and pc.entry_slot >= 0
    assert_same_state(jc, pc)
    # Delete everything: no entry point, searches answer (-1, +inf).
    rest = list(range(N))
    jc.delete(rest)
    pc.delete(rest)
    assert pc.entry_slot == -1 and pc.count == 0
    assert_same_state(jc, pc)
    ids, dists = pc.search(_data()[:2], 3)
    assert (ids == -1).all() and np.isinf(dists).all()


def test_select_fallback_entry_matches_jax():
    from duckdb_lm_diskann_tpu.core.builder import (
        select_fallback_entry as jax_select,
    )

    jc, pc = pair("int4")
    jc.delete(list(range(0, N, 7)))
    pc.delete(list(range(0, N, 7)))
    nbrs, valid = np.asarray(jc.arrays.neighbors), np.asarray(jc.arrays.valid)
    want = jax_select(jc.allocator.slot_to_rowid, nbrs, valid)
    assert pc._select_fallback_entry() == want
    assert port_builder.select_fallback_entry({}, nbrs, valid) == (-1, -1)


def test_delete_orphan_rescue_matches_jax(rng):
    """Deleting every in-neighbor of a node must not strand it: the delete
    path force-links it from a live ex-sibling (tests/test_lifecycle.py's
    scenario, on both sides)."""
    from duckdb_lm_diskann_tpu.core.coordinator import (
        Coordinator as JaxCoordinator,
    )

    jax_cfg, port_cfg = configs(
        metric="l2", edge_type="int8", dims=8, r=4, l_insert=8, l_search=64
    )
    n = 80
    data = rng.standard_normal((n, 8)).astype(np.float32)
    jc = JaxCoordinator(jax_cfg)
    jc.bulk_build(list(range(n)), data)
    pc = port_coordinator_from_jax(jc, port_cfg)
    nbrs = np.asarray(jc.arrays.neighbors[: jc.allocator.high_water])
    for x in range(1, n):
        in_rows = [
            int(s) for s in np.nonzero((nbrs == x).any(axis=1))[0] if s != x
        ]
        if x != jc.entry_slot and 1 <= len(in_rows) <= 6:
            break
    x_row = jc.allocator.slot_to_rowid[x]
    jc.delete(in_rows)
    pc.delete(in_rows)
    assert_same_state(jc, pc)
    hist = port_builder.inlink_histogram(
        pc.arrays.neighbors, pc.arrays.valid, pc.capacity
    )
    assert int(hist[x]) >= 1  # rescued: an in-link from a live row
    ids = _same_search(jc, pc, data[x][None, :], k=3, l_search=64)
    assert x_row in ids[0].tolist()


def test_rescue_orphans_round_matches_jax(rng):
    """The rescue round on a hand-made graph (tests/test_lifecycle.py's
    unit case): node 4 has no in-link and is adopted by its nearest live
    ex-sibling; node 1 keeps its in-link and adopts nothing."""
    import jax.numpy as jnp

    from duckdb_lm_diskann_tpu.core.builder import (
        rescue_orphans_round as jax_rescue,
    )
    from duckdb_lm_diskann_tpu.core.graph import (
        GraphParams as JaxParams,
        make_graph_arrays as jax_make,
    )
    from duckdb_lm_diskann_tpu_torch.core.graph import (
        graph_arrays_from_numpy,
    )

    jax_cfg, port_cfg = configs(
        metric="l2", edge_type="int8", dims=4, r=4, l_insert=8, l_search=16
    )
    vecs = rng.standard_normal((64, 4)).astype(np.float32)
    nbr = np.array(
        [[1, -1, -1, -1], [0, -1, -1, -1], [3, -1, -1, -1],
         [2, -1, -1, -1], [0, 1, -1, -1], [0, -1, -1, -1]]
        + [[-1] * 4] * 58, np.int32,
    )
    arrays = jax_make(JaxParams.from_config(jax_cfg), 64)._replace(
        vectors=jnp.asarray(vecs),
        valid=jnp.zeros(64, bool).at[jnp.arange(6)].set(True),
        neighbors=jnp.asarray(nbr),
    )
    port_arrays = graph_arrays_from_numpy(arrays, "cpu")
    tgt = np.array([4, 1] + [-1] * 6, np.int32)
    sibs = np.array([[1, 2, 3, 5], [0, 2, -1, -1]] + [[-1] * 4] * 6, np.int32)
    dels = np.full(4, -1, np.int32)
    want, want_adopt = jax_rescue(
        arrays, jnp.asarray(tgt), jnp.asarray(sibs), jnp.asarray(dels),
        params=JaxParams.from_config(jax_cfg),
    )
    got, got_adopt = port_builder.rescue_orphans_round(
        port_arrays, torch.from_numpy(tgt), torch.from_numpy(sibs),
        torch.from_numpy(dels), params=GraphParams.from_config(port_cfg),
    )
    np.testing.assert_array_equal(got_adopt.numpy(), np.asarray(want_adopt))
    np.testing.assert_array_equal(
        got.neighbors.numpy(), np.asarray(want.neighbors)
    )
    np.testing.assert_array_equal(
        got.dirty_rows.numpy(), np.asarray(want.dirty_rows)
    )
    adopters = [a for a in got_adopt.tolist() if a >= 0]
    d = np.linalg.norm(vecs[[1, 2, 3, 5]] - vecs[4], axis=1)
    assert adopters == [[1, 2, 3, 5][int(np.argmin(d))]]


def test_plan_delete_repair_matches_jax_unpadded():
    """The port's plan is the JAX plan without its pow2 >= 256 padding:
    round k repairs each target against its k-th adjacent deleted node."""
    from duckdb_lm_diskann_tpu.core.builder import (
        plan_delete_repair as jax_plan,
    )

    rng = np.random.default_rng(9)
    nbr_rows = rng.integers(-1, 50, (12, 6)).astype(np.int32)
    del_slots = np.arange(12, dtype=np.int32) * 4
    want, want_rescue = jax_plan(nbr_rows, del_slots, 6)
    got, got_rescue = port_builder.plan_delete_repair(nbr_rows, del_slots, 6)
    assert len(got) == len(want) > 1
    for (t, e), (wt, we) in zip(got, want):
        u = len(t)
        np.testing.assert_array_equal(t, wt[:u])
        np.testing.assert_array_equal(e, we[:u])
        assert (wt[u:] == -1).all()
    u = len(got_rescue[0])
    np.testing.assert_array_equal(got_rescue[0], want_rescue[0][:u])
    np.testing.assert_array_equal(got_rescue[1], want_rescue[1][:u])
    assert port_builder.plan_delete_repair(
        np.full((2, 6), -1, np.int32), np.asarray([0, 1], np.int32), 6
    ) == ([], None)


def test_vacuum_slot_order_matches_jax():
    jc, pc = pair("int4")
    new = np.random.default_rng(3).standard_normal((40, DIMS)).astype(
        np.float32
    )
    for c in (jc, pc):
        c.delete([3, 4, 5, 50, 51])
        # Quarantined until vacuum: the next row takes the high water mark.
        c.insert([1000], new[:1])
    assert pc.allocator.rowid_to_slot[1000] == N
    assert pc.vacuum() == jc.vacuum() == 5
    assert_same_state(jc, pc)
    for c in (jc, pc):
        c.insert(list(range(1001, 1040)), new[1:])
    # Recycled last in, first out, then the high water mark again.
    assert [pc.allocator.rowid_to_slot[r] for r in range(1001, 1007)] == [
        51, 50, 5, 4, 3, N + 1,
    ]
    assert_same_state(jc, pc)
    ids = _same_search(jc, pc, new[:8])
    assert ids[:, 0].tolist() == list(range(1000, 1008))


def test_update_matches_jax():
    jc, pc = pair("ternary")
    vec = np.random.default_rng(4).standard_normal(DIMS).astype(np.float32)
    jc.update(7, vec)
    pc.update(7, vec)
    assert pc.count == N
    assert_same_state(jc, pc)
    ids = _same_search(jc, pc, vec[None, :], k=1)
    assert ids[0, 0] == 7


def test_repair_reachability_matches_jax(rng):
    """tests/test_lifecycle.py's fixpoint case on both sides: the same
    nodes relinked and the same reachable fraction (>= 0.99, that test's
    bound; on this graph both sides stall at 0.994, where each further
    round relinks 24 nodes and strands as many), then full reachability
    after churn and two vacuums."""
    from duckdb_lm_diskann_tpu.core.coordinator import (
        Coordinator as JaxCoordinator,
    )
    from duckdb_lm_diskann_tpu.utils.verify import (
        verify_graph as jax_verify,
    )

    jax_cfg, port_cfg = configs(
        metric="l2", edge_type="int4", dims=24, r=8, l_insert=16, l_search=64
    )
    data = rng.standard_normal((500, 24)).astype(np.float32)
    jc = JaxCoordinator(jax_cfg)
    jc.bulk_build(list(range(500)), data)
    pc = port_coordinator_from_jax(jc, port_cfg)
    pre = verify_graph(pc)["reachable_fraction"]
    assert pre == jax_verify(jc)["reachable_fraction"]
    relinked = pc.repair_reachability()
    assert relinked == jc.repair_reachability()
    post = verify_graph(pc)["reachable_fraction"]
    assert post == jax_verify(jc)["reachable_fraction"]
    assert post >= max(pre, 0.99)
    if pre < 1.0:
        assert relinked > 0 and post > pre
    assert_same_state(jc, pc)
    new = rng.standard_normal((50, 24)).astype(np.float32)
    for c in (jc, pc):
        c.insert(list(range(1000, 1050)), new)
        c.delete(list(range(40, 80)))
        c.vacuum()
        c.vacuum()
    assert verify_graph(pc)["reachable_fraction"] == 1.0
    assert_same_state(jc, pc)


def test_refine_matches_jax():
    """refine on a carried-across graph: the same rows refined, identical
    tables (its reachability repair included)."""
    jc, pc = pair("int4")
    assert pc.refine(max_batch=64) == jc.refine(max_batch=64) == N
    assert_same_state(jc, pc)
    _same_search(jc, pc, _data()[:12] + 0.01)


def test_handle_commit_drop_matches_jax():
    jc, pc = pair("int4")
    jc.handle_commit_drop()
    pc.handle_commit_drop()
    assert pc.count == 0 and pc.entry_slot == -1 and not pc.dirty
    assert pc.capacity == jc.capacity
    assert pc.arrays.device.type == "cpu"
    assert_same_state(jc, pc)


@pytest.mark.parametrize(
    "codec,metric,vtype",
    [
        ("int4", "l2", "float32"), ("int8", "l2", "int8"),
        ("ternary", "cosine", "float32"), ("float32", "ip", "float32"),
        ("float16", "l2", "int8"), ("float1bit", "cosine", "float32"),
        ("none", "cosine", "float32"),
    ],
)
def test_in_memory_size_matches_jax(codec, metric, vtype):
    from duckdb_lm_diskann_tpu.common import types as jt
    from duckdb_lm_diskann_tpu.core.coordinator import (
        Coordinator as JaxCoordinator,
    )
    from duckdb_lm_diskann_tpu_torch.common.types import VectorType

    jax_cfg, port_cfg = configs(metric=metric, edge_type=codec, dims=12)
    jax_cfg.node_vector_type = jt.VectorType(vtype)
    port_cfg.node_vector_type = VectorType(vtype)
    jc = JaxCoordinator(jax_cfg, initial_capacity=256)
    pc = Coordinator(port_cfg, initial_capacity=256, device="cpu")
    size = pc.get_in_memory_size()
    assert size == jc.get_in_memory_size()
    pc.insert([0], np.ones((1, 12), np.float32))
    assert pc.get_in_memory_size() == size  # preallocated


def test_recall_under_churn(rng):
    """Delete 30%, vacuum, and recall@10 over the survivors against brute
    force stays >= 0.9 (tests/test_lifecycle.py's bound), with no deleted
    row returned."""
    _, cfg = configs(
        metric="l2", edge_type="int8", dims=16, r=16, l_insert=32,
        l_search=64,
    )
    coord = Coordinator(cfg, device="cpu")
    n = 600
    data = rng.standard_normal((n, 16)).astype(np.float32)
    coord.bulk_build(list(range(n)), data)
    victims = rng.choice(n, n * 3 // 10, replace=False)
    coord.delete(victims.tolist())
    assert coord.vacuum() == len(victims)
    alive = np.setdiff1d(np.arange(n), victims)
    queries = data[alive[:32]] + 0.01 * rng.standard_normal((32, 16)).astype(
        np.float32
    )
    ids, dists = coord.search(queries, 10, l_search=64)
    d = pairwise_distance(
        torch.from_numpy(queries)[:, None, :].double(),
        torch.from_numpy(data[alive])[None, :, :].double(),
        coord.params.metric,
    ).numpy()
    truth = alive[np.argsort(d, axis=1, kind="stable")[:, :10]]
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, truth)])
    assert not np.isin(ids, victims).any()
    assert rec >= 0.9, rec
    assert verify_graph(coord)["reachable_fraction"] == 1.0


@pytest.mark.cuda
def test_lifecycle_on_the_card_matches_cpu():
    """Build, delete, vacuum, refine and re-insert on the card against the
    same steps on the CPU: the card sums f32 in another order, so hold
    recall overlap >= 0.95 and exact distances, not identity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from duckdb_lm_diskann_tpu_torch.kernels import int4_frontier

    rng = np.random.default_rng(21)
    n, dims = 2000, 24
    data = rng.standard_normal((n, dims)).astype(np.float32)
    queries = data[:64] + 0.01
    _, cfg = configs(metric="l2", edge_type="int4", dims=dims, r=12,
                     l_insert=24, l_search=40)
    victims = rng.choice(n, 200, replace=False).tolist()
    out = {}
    for dev in ("cpu", "cuda"):
        coord = Coordinator(cfg, initial_capacity=n, device=dev)
        coord.bulk_build(range(n), data, max_batch=256)
        coord.refine(max_batch=256)
        before = int4_frontier.LAUNCHES
        coord.delete(victims)
        assert coord.vacuum() == len(victims)
        # tests/test_lifecycle.py's bound for one repair: a force-link
        # into a full row can strand another node.
        assert verify_graph(coord)["reachable_fraction"] >= 0.99, dev
        coord.insert(victims, data[victims])
        assert {coord.allocator.rowid_to_slot[v] for v in victims} <= set(
            range(n)
        )  # every re-inserted row took a recycled slot
        ids, dists = coord.search(queries, 10)
        if dev == "cuda":
            assert int4_frontier.LAUNCHES > before
        out[dev] = ids, dists
    (want, _), (got, got_d) = out["cpu"], out["cuda"]
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, want)])
    assert overlap >= 0.95, overlap
    exact = pairwise_distance(
        torch.from_numpy(queries)[:, None, :].double(),
        torch.from_numpy(data[got]).double(), cfg.metric_type,
    ).numpy()
    np.testing.assert_allclose(got_d, exact, atol=1e-4)
