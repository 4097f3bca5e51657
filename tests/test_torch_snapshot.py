"""Snapshots, point-in-time read views and the insert rollback of the
PyTorch port, on the CPU.

The cases of ``tests/test_snapshot.py`` on the port, then the two repairs
that make the port's state as isolated as the JAX package's:

* with ``donate_buffers=False`` every mutation writes copies, so a
  ``ReadView`` captured earlier answers exactly as before, and as the JAX
  Coordinator's view under the same steps;
* a failed insert step restores every row it wrote (an undo journal), so
  the state after the rollback is the JAX Coordinator's after the same
  failure.
"""

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu_torch.core import builder as port_builder
from duckdb_lm_diskann_tpu_torch.core import coordinator as port_coord_mod
from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from tests.torch_configs import (
    assert_same_state,
    configs,
    port_coordinator_from_jax,
)
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)


def make_coord(rng, n=120, dims=16):
    _, cfg = configs(metric="l2", edge_type="int4", dims=dims, r=8,
                     l_insert=16, l_search=48)
    coord = Coordinator(cfg, device="cpu")
    data = rng.standard_normal((n, dims)).astype(np.float32)
    coord.bulk_build(list(range(n)), data)
    return coord, data


def test_snapshot_does_not_see_later_mutations(rng):
    coord, data = make_coord(rng)
    snap = coord.snapshot()
    new = rng.standard_normal((30, 16)).astype(np.float32)
    coord.delete([7, 11])
    coord.insert(list(range(1000, 1030)), new)
    coord.vacuum()

    ids_live, _ = coord.search(data[7:8], 3)
    assert 7 not in ids_live[0]
    ids_new, _ = coord.search(new[0:1], 1)
    assert ids_new[0, 0] == 1000

    # The snapshot sees the deleted row and none of the later inserts.
    ids_snap, d_snap = snap.search(data[7:8], 3)
    assert ids_snap[0, 0] == 7 and d_snap[0, 0] < 1e-5
    ids_snap2, _ = snap.search(new[0:1], 3)
    assert 1000 not in ids_snap2[0]
    assert snap.count == 120 and coord.count == 148
    assert snap.arrays.vectors.device == coord.arrays.vectors.device


def test_snapshot_is_read_only(rng):
    coord, _ = make_coord(rng, n=40)
    snap = coord.snapshot()
    vec = rng.standard_normal((1, 16)).astype(np.float32)
    for mutate in (
        lambda: snap.insert([999], vec),
        lambda: snap.delete([0]),
        lambda: snap.update(0, vec[0]),
        lambda: snap.vacuum(),
        lambda: snap.refine(),
        lambda: snap.repair_reachability(),
        lambda: snap.bulk_build([999], vec),
    ):
        with pytest.raises(RuntimeError, match="read-only"):
            mutate()
    assert not snap.dirty and not snap.donate_buffers
    coord.insert([999], vec)  # the live index stays mutable


def test_snapshot_equals_live_at_capture_time(rng):
    coord, _ = make_coord(rng, n=80)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    want_ids, want_d = coord.search(q, 5)
    snap = coord.snapshot()
    coord.delete(list(range(0, 80, 3)))
    coord.insert(
        list(range(2000, 2040)),
        rng.standard_normal((40, 16)).astype(np.float32),
    )
    got_ids, got_d = snap.search(q, 5)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_d, want_d)


def _jax_pair(rng, n=300, dims=16):
    """A JAX-built INT4 graph and its port copy, with queries."""
    from duckdb_lm_diskann_tpu.core.coordinator import (
        Coordinator as JaxCoordinator,
    )

    jax_cfg, port_cfg = configs(metric="l2", edge_type="int4", dims=dims,
                                r=8, l_insert=16, l_search=32)
    data = rng.standard_normal((n, dims)).astype(np.float32)
    jc = JaxCoordinator(jax_cfg, initial_capacity=512)
    jc.bulk_build(list(range(n)), data, max_batch=64)
    pc = port_coordinator_from_jax(jc, port_cfg)
    queries = data[:16] + 0.01
    return jc, pc, data, queries


def test_read_view_is_point_in_time_without_donation(rng):
    """With donate_buffers False, a view captured before an insert, a
    delete and a vacuum answers exactly as at capture, on both sides; the
    live index sees the changes."""
    jc, pc, data, queries = _jax_pair(rng)
    new = rng.standard_normal((40, 16)).astype(np.float32)
    views, before = {}, {}
    for name, c in (("jax", jc), ("port", pc)):
        c.donate_buffers = False
        views[name] = c.capture_view()
        before[name] = c.search(queries, 10, view=views[name])
        c.insert(list(range(1000, 1040)), new)
        c.delete(list(range(0, 100, 2)))
        c.vacuum()
    assert_same_state(jc, pc)
    got = pc.search(queries, 10, view=views["port"])
    want = jc.search(queries, 10, view=views["jax"])
    for a, b in ((got, before["port"]), (want, before["jax"]), (got, want)):
        np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(got[1], before["port"][1])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    live_ids, _ = pc.search(queries, 10)
    assert not np.isin(live_ids, np.arange(0, 100, 2)).any()
    assert np.isin(got[0], np.arange(0, 100, 2)).any()


def test_read_view_with_donation_shares_the_live_tensors(rng):
    """The default (donation on, as in the JAX package): mutations write in
    place, and the view holds the same tensors."""
    coord, data = make_coord(rng, n=60)
    assert coord.donate_buffers
    view = coord.capture_view()
    coord.delete([1, 2, 3])
    assert view.arrays.neighbors is coord.arrays.neighbors
    assert not bool(view.arrays.valid[[1, 2, 3]].any())  # seen in place


class _Failure(RuntimeError):
    pass


@pytest.mark.parametrize("donate", [True, False])
def test_failed_insert_step_rolls_back_like_jax(rng, monkeypatch, donate):
    """Fail the third batch of an insert partway: the port raises from its
    second reciprocal edge-code write, after the batch has written vectors,
    neighbor rows, reciprocal edges and codes; JAX fails the same batch.
    Every table, the entry point and the allocator then equal JAX's, and
    without donation a view captured before the call answers as before.
    (With donation the view shares the live tensors, where the call's first
    two batches stay written, out of the live mask.)"""
    import duckdb_lm_diskann_tpu.core.coordinator as jax_coord_mod

    jc, pc, data, queries = _jax_pair(rng)
    new = rng.standard_normal((100, 16)).astype(np.float32)
    for c in (jc, pc):
        c.max_insert_batch = 32  # batches of 32, 32, 32, 4
        c.donate_buffers = donate
    view = pc.capture_view()
    view_before = pc.search(queries, 10, view=view)

    jax_real = jax_coord_mod.insert_batch
    jax_calls = []

    def jax_failing(*args, **kwargs):
        jax_calls.append(1)
        if len(jax_calls) == 3:
            raise _Failure("injected")
        return jax_real(*args, **kwargs)

    port_real_batch = port_coord_mod.insert_batch
    port_real_write = port_builder.write_single_edge_codes
    state = {"batch": 0, "writes": 0, "pre": None, "raised": False}

    def port_batch(arrays, *args, **kwargs):
        state["batch"] += 1
        state["writes"] = 0
        if state["batch"] == 3:
            state["pre"] = [t.clone() for t in arrays]
        return port_real_batch(arrays, *args, **kwargs)

    def port_write(arrays, *args, **kwargs):
        if state["batch"] == 3:
            state["writes"] += 1
            if state["writes"] == 2:
                changed = [
                    name for name, a, b in
                    zip(arrays._fields, arrays, state["pre"])
                    if not torch.equal(a, b)
                ]
                # The batch has already written these tables.
                assert {"vectors", "valid", "neighbors", "edge_i4",
                        "dirty_rows"} <= set(changed), changed
                state["raised"] = True
                raise _Failure("injected")
        return port_real_write(arrays, *args, **kwargs)

    monkeypatch.setattr(jax_coord_mod, "insert_batch", jax_failing)
    monkeypatch.setattr(port_coord_mod, "insert_batch", port_batch)
    monkeypatch.setattr(port_builder, "write_single_edge_codes", port_write)
    for c in (jc, pc):
        with pytest.raises(_Failure):
            c.insert(list(range(1000, 1100)), new)
    assert state["raised"]
    assert pc.count == 300 and pc._ever_tombstoned
    assert sorted(pc.allocator.pending_deletion) == list(range(300, 400))
    assert_same_state(jc, pc)
    if not donate:
        got = pc.search(queries, 10, view=view)
        np.testing.assert_array_equal(got[0], view_before[0])
        np.testing.assert_array_equal(got[1], view_before[1])

    # The index goes on: the same rows insert into fresh slots.
    monkeypatch.setattr(jax_coord_mod, "insert_batch", jax_real)
    monkeypatch.setattr(port_coord_mod, "insert_batch", port_real_batch)
    monkeypatch.setattr(port_builder, "write_single_edge_codes", port_real_write)
    for c in (jc, pc):
        c.insert(list(range(1000, 1100)), new)
    assert_same_state(jc, pc)
    want_ids, want_d = jc.search(new[:8], 5)
    got_ids, got_d = pc.search(new[:8], 5)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-6)


def test_undo_journal_restores_in_reverse_order():
    t = torch.arange(10, dtype=torch.int32)
    m = torch.zeros((4, 3), dtype=torch.float32)
    j = port_builder.UndoJournal()
    rows = torch.tensor([2, 5, 2])  # a repeated row restores one value
    j.save(t, rows)
    t[rows] = -1
    j.save(t, torch.tensor([5, 6]))
    t[torch.tensor([5, 6])] = -2
    j.save(m, torch.tensor([1, 3]), torch.tensor([0, 2]))
    m[torch.tensor([1, 3]), torch.tensor([0, 2])] = 7.0
    j.rollback()
    assert t.tolist() == list(range(10)) and not m.any()
    j.rollback()  # empty: a no-op
