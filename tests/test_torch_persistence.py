"""Persistence of the PyTorch port (``store/``) on the CPU, against the JAX
package.

The cases of ``tests/test_persistence.py`` on the port: codec round trips,
the reference layout, the native and Python block files, the shadow delta
log, checksum corruption, crashes between and inside the checkpoint
phases, crash recovery, incremental and multi-chunk saves, and loading
after every row was deleted. Then the cross-package cases, which hold the
two packages to one on-disk format:

* the same host arrays encode to byte-identical blocks, for every codec and
  both node-vector types;
* the same index state saved by each package gives a byte-identical
  graph.lmd with identical CRCs, and each package's checkpoint opens in the
  other with every table, map and entry identical (synthetic states for
  every codec, and a graph the JAX package built);
* the same insert/delete/update sequence leaves the same delta log.

The JAX graph is built once per process (``_jax_built``); everything else
on the JAX side is encoding, saving and loading, which compile nothing. The
``cuda`` case checks a checkpoint on the card; it skips without one. The
modules of the JAX package that import jax are imported inside the tests
that use them, so the ``cuda`` case also runs where JAX is not installed.
"""

import shutil

import numpy as np
import pytest
import torch

from duckdb_lm_diskann_tpu.store import block_codec as jax_codec
from duckdb_lm_diskann_tpu.store.shadow import (
    ShadowStorageService as JaxShadow,
)
from duckdb_lm_diskann_tpu_torch.core import coordinator as port_coord_mod
from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator
from duckdb_lm_diskann_tpu_torch.ops.quantize import (
    encode_int4_np,
    encode_int8_np,
    i4_planar_from_packed_np,
)
from duckdb_lm_diskann_tpu_torch.ops.ternary import encode_ternary_np
from duckdb_lm_diskann_tpu_torch.store import block_codec, checkpoint, file_service
from duckdb_lm_diskann_tpu_torch.store.file_service import (
    NativeBlockFile,
    PyBlockFile,
    build_native,
    open_block_file,
)
from duckdb_lm_diskann_tpu_torch.store.shadow import (
    PrimaryStorageService,
    ShadowStorageService,
)
from tests.torch_configs import (
    assert_same_state,
    configs,
    jax_coordinator_copy,
    jax_graph,
    port_coordinator_from_jax,
)
from tests.torch_cpu import jax_map_budget, one_torch_thread  # noqa: F401  (autouse)

# (metric, edge codec) of every codec, with a metric each allows.
CODECS = [
    ("cosine", "ternary"), ("l2", "int8"), ("l2", "int4"), ("l2", "float32"),
    ("l2", "float16"), ("cosine", "float1bit"), ("cosine", "none"),
]
CODEC_IDS = [c for _, c in CODECS]


def both_configs(metric, edge_type, dims=16, r=8, node="float32"):
    """(JAX config, port config) of tests/test_persistence.py's
    make_config, with either node-vector type."""
    jax_cfg, cfg = configs(
        metric=metric, edge_type=edge_type, dims=dims, r=r,
        l_insert=max(16, 2 * r), l_search=32,
    )
    for c in (jax_cfg, cfg):
        c.node_vector_type = type(c.node_vector_type)(node)
        c.validate()
    return jax_cfg, cfg


def built(cfg, data, rowids=None):
    coord = Coordinator(cfg, device="cpu")
    coord.bulk_build(list(range(len(data))) if rowids is None else rowids, data)
    return coord


def load(directory, **kw):
    return checkpoint.load_index(directory, device="cpu", **kw)


# --------------------------------------------------------------------- #
# block codec


def _host_rows(rng, cfg, n):
    """Random rows of every field a codec persists: the JAX package's dtypes
    (uint32 words) and the port's (int32 words with the same bits)."""
    r, d = cfg.r, cfg.dimensions
    if cfg.node_vector_type.value == "int8":
        vectors = rng.integers(-128, 128, (n, d)).astype(np.float32)
    else:
        vectors = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.integers(0, 1000, (n, r)).astype(np.int64)
    ids[:, -2:] = -1  # empty slots
    nbr = rng.standard_normal((n, r, d)).astype(np.float32)
    et = cfg.resolve_edge_type().value
    kw = {}
    if et == "ternary":
        kw["edge_pos"], kw["edge_neg"] = encode_ternary_np(nbr)
    elif et == "float1bit":
        kw["edge_pos"] = encode_ternary_np(nbr)[0]
    elif et == "int8":
        kw["edge_i8"], kw["edge_scale"] = encode_int8_np(nbr)
    elif et == "int4":
        kw["edge_i4"], kw["edge_scale"] = encode_int4_np(nbr)
    elif et == "float16":
        kw["edge_f32"] = nbr.astype(np.float16)
    elif et == "float32":
        kw["edge_f32"] = nbr
    port_kw = {
        k: v.view(np.int32) if v.dtype == np.uint32 else v for k, v in kw.items()
    }
    return vectors, ids, kw, port_kw


@pytest.mark.parametrize("node", ["float32", "int8"])
@pytest.mark.parametrize("metric,edge_type", CODECS, ids=CODEC_IDS)
def test_codec_matches_jax_and_round_trips(rng, metric, edge_type, node):
    """Both packages encode the same rows to the same bytes (the port's
    int32 words as the JAX package's uint32 ones), and the port decodes its
    blocks back to the rows (words as int32)."""
    jax_cfg, cfg = both_configs(metric, edge_type, node=node)
    vectors, ids, kw, port_kw = _host_rows(rng, cfg, 5)
    want = jax_codec.encode_blocks(jax_cfg, vectors, ids, **kw)
    blocks = block_codec.encode_blocks(cfg, vectors, ids, **port_kw)
    lay = block_codec.resolve_layout(cfg)
    assert blocks.shape == (5, lay.block_size) and lay.block_size % 4096 == 0
    assert lay.block_size == jax_codec.resolve_layout(jax_cfg).block_size
    np.testing.assert_array_equal(blocks, want)

    out = block_codec.decode_blocks(cfg, blocks)
    np.testing.assert_array_equal(out["counts"], (ids >= 0).sum(1))
    np.testing.assert_array_equal(out["vectors"], vectors)
    assert out["vectors"].dtype == (np.int8 if node == "int8" else np.float32)
    np.testing.assert_array_equal(out["neighbor_rowids"], ids)
    assert set(out) - {"counts", "vectors", "neighbor_rowids"} == set(port_kw)
    for name, rows in port_kw.items():
        assert out[name].dtype == rows.dtype, name
        np.testing.assert_array_equal(out[name], rows, err_msg=name)


def test_codec_reference_layout_positions(rng):
    """Raw byte positions against the reference layout arithmetic
    (index_config.cpp:104-148) for D=128, R=64 / FLOAT32 / TERNARY."""
    _, cfg = both_configs("cosine", "ternary", dims=128, r=64)
    vectors = rng.standard_normal((1, 128)).astype(np.float32)
    ids = np.full((1, 64), -1, np.int64)
    ids[0, 0] = 42
    pos, neg = encode_ternary_np(rng.standard_normal((1, 64, 128)))
    blk = block_codec.encode_blocks(
        cfg, vectors, ids, edge_pos=pos.view(np.int32), edge_neg=neg
    )[0]
    assert int(blk[0:2].view(np.uint16)[0]) == 1  # count @0 (u16)
    np.testing.assert_array_equal(blk[8:520].view(np.float32), vectors[0])
    assert int(blk[520:528].view(np.int64)[0]) == 42  # neighbor ids @520
    assert (blk[528:1032].view(np.int64) == block_codec.ROW_ID_SENTINEL).all()
    # pos planes @1032: the first neighbor's plane as u64 == LE u32 pair
    u64_words = blk[1032:1048].copy().view(np.uint64)
    u32_pair = pos[0, 0]
    assert int(u64_words[0]) == int(u32_pair[0]) | (int(u32_pair[1]) << 32)
    assert len(blk) == 4096


# --------------------------------------------------------------------- #
# block file (native + python, same on-disk format)


def test_native_build_is_keyed_and_a_failed_build_raises(tmp_path, monkeypatch):
    so = build_native()
    assert so.parent == file_service.BUILD_DIR and so == file_service.library_path()
    assert build_native() == so  # built once per source and flags
    assert open_block_file(tmp_path / "a.lmd", 4096).backend == "native"
    py = open_block_file(tmp_path / "b.lmd", 4096, prefer_native=False)
    assert py.backend == "python"
    py.close()

    broken = tmp_path / "blockstore.cpp"
    broken.write_text("int bs_open( {\n")
    monkeypatch.setattr(file_service, "_SOURCE", broken)
    assert file_service.library_path() != so
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        build_native()
    assert "error" in str(err.value)  # the compiler's log
    assert not file_service.library_path().exists()
    assert not list(file_service.BUILD_DIR.glob(
        file_service.library_path().name + ".*"))


@pytest.mark.parametrize("cls", [NativeBlockFile, PyBlockFile])
def test_block_file_roundtrip(tmp_path, rng, cls):
    path = tmp_path / "graph.lmd"
    bs = 4096
    f = cls(path, bs)
    data = rng.integers(0, 256, (6, bs)).astype(np.uint8)
    f.write_blocks(0, data[:4])
    f.write_blocks_at(np.asarray([5, 4]), data[4:6])
    assert f.num_blocks == 6
    np.testing.assert_array_equal(f.read_blocks(0, 4), data[:4])
    np.testing.assert_array_equal(f.read_blocks_at([5, 4]), data[4:6])
    crc = f.crc32_rows(data)
    assert len(crc) == 6 and len(set(crc.tolist())) > 1
    f.sync()
    assert f.file_size() == 4096 + 6 * bs
    f.truncate(3)
    assert f.num_blocks == 3
    f.close()
    f2 = cls(path, bs)
    assert f2.num_blocks == 3
    np.testing.assert_array_equal(f2.read_blocks(0, 3), data[:3])
    assert f2.clean_shutdown
    f2.close()


def test_native_and_python_formats_interchange(tmp_path, rng):
    """Files and CRCs interchange, also over the native store's threaded
    CRC (a batch large enough to be split)."""
    path = tmp_path / "x.lmd"
    data = rng.integers(0, 256, (3, 4096)).astype(np.uint8)
    nf = NativeBlockFile(path, 4096)
    nf.write_blocks(0, data)
    crc_native = nf.crc32_rows(data)
    big = rng.integers(0, 256, (4096 + 3, 4096)).astype(np.uint8)
    big_native = nf.crc32_rows(big)
    nf.close()
    pf = PyBlockFile(path, 4096, create=False)
    np.testing.assert_array_equal(pf.read_blocks(0, 3), data)
    np.testing.assert_array_equal(pf.crc32_rows(data), crc_native)
    np.testing.assert_array_equal(pf.crc32_rows(big), big_native)
    pf.close()


@pytest.mark.parametrize("cls", [NativeBlockFile, PyBlockFile])
def test_async_flush_engine(tmp_path, rng, cls):
    """Background writer: submission order preserved, the fsync barrier
    drains, close drains, contents identical to synchronous writes."""
    path = tmp_path / "graph.lmd"
    bs = 512
    f = cls(path, bs)
    a = rng.integers(0, 256, (100, bs)).astype(np.uint8)
    b = rng.integers(0, 256, (50, bs)).astype(np.uint8)
    c = rng.integers(0, 256, (100, bs)).astype(np.uint8)
    f.submit_write(0, a)
    f.submit_write_at(np.arange(100, 150, dtype=np.uint64), b)
    f.submit_write(0, c)  # a later job overwrites an earlier range
    f.flush_wait(f.submit_sync())
    assert f.async_pending() == 0
    got = f.read_blocks(0, 150)
    np.testing.assert_array_equal(got[:100], c)
    np.testing.assert_array_equal(got[100:], b)
    f.submit_write(150, a)
    f.close()
    f2 = cls(path, bs)
    np.testing.assert_array_equal(f2.read_blocks(150, 100), a)
    assert f2.num_blocks == 250
    f2.close()


def test_async_flush_fail_stop(tmp_path, rng, monkeypatch):
    """The first async-write failure is sticky: flush_wait raises, later
    jobs are skipped, and close() still drains without raising."""
    bs = 256
    f = PyBlockFile(tmp_path / "g.lmd", bs)
    a = rng.integers(0, 256, (4, bs)).astype(np.uint8)
    real_write = PyBlockFile.write_blocks
    calls = {"n": 0}

    def flaky(self, first, blocks):
        calls["n"] += 1
        if calls["n"] == 2:
            raise IOError("disk gone")
        return real_write(self, first, blocks)

    monkeypatch.setattr(PyBlockFile, "write_blocks", flaky)
    f.submit_write(0, a)
    f.submit_write(4, a)  # fails
    j3 = f.submit_write(8, a)  # skipped (fail-stop)
    with pytest.raises(IOError, match="disk gone"):
        f.flush_wait(j3)
    monkeypatch.undo()
    f.close()
    f2 = PyBlockFile(tmp_path / "g.lmd", bs)
    np.testing.assert_array_equal(f2.read_blocks(0, 4), a)
    assert f2.num_blocks == 4
    f2.close()


# --------------------------------------------------------------------- #
# shadow store


def test_shadow_delta_log_and_metadata(tmp_path):
    s = ShadowStorageService(tmp_path)
    s.log_insert_batch([1, 2], [0, 1])
    s.log_delete_batch([1])
    assert [(d[1], d[2]) for d in s.pending_deltas()] == [
        ("insert", 1), ("insert", 2), ("delete", 1)]
    s.set_metadata("entry_rowid", 7)
    assert s.get_metadata("entry_rowid") == 7
    s.commit_checkpoint({2: 1}, [0], np.asarray([11, 22], np.uint32),
                        {"count": 1})
    assert s.pending_deltas() == []
    assert s.load_lookup() == {2: 1}
    assert s.load_tombstones() == [0]
    assert s.load_checksums() == {0: 11, 1: 22}
    assert s.get_metadata("merge_sequence_number") == 1
    s.close()


# --------------------------------------------------------------------- #
# end-to-end checkpoint


@pytest.mark.parametrize("metric,edge_type", [
    ("cosine", "ternary"), ("l2", "int8"), ("l2", "float16"),
    ("cosine", "float1bit"),
])
def test_save_load_roundtrip(tmp_path, rng, metric, edge_type):
    _, cfg = both_configs(metric, edge_type)
    n = 80
    data = rng.standard_normal((n, cfg.dimensions)).astype(np.float32)
    rowids = [i * 10 for i in range(n)]  # non-dense rowids
    coord = built(cfg, data, rowids)
    coord.delete([rowids[5], rowids[17]])

    d = tmp_path / "idx"
    stats = checkpoint.save_index(coord, d)
    assert stats["backend"] == "native" and not coord.dirty
    assert not coord.arrays.dirty_rows.any()
    loaded = load(d)
    assert loaded.device.type == "cpu"
    assert loaded.count == coord.count
    assert loaded.entry_rowid == coord.entry_rowid
    assert loaded.allocator.rowid_to_slot == coord.allocator.rowid_to_slot
    assert loaded.allocator.pending_deletion == coord.allocator.pending_deletion
    valid = coord.arrays.valid[:n].numpy()
    np.testing.assert_array_equal(loaded.arrays.valid[:n].numpy(), valid)
    # Dead slots serialize zeroed; live rows round-trip exactly.
    np.testing.assert_array_equal(
        loaded.arrays.vectors[:n].numpy()[valid],
        coord.arrays.vectors[:n].numpy()[valid])

    q = rng.standard_normal((6, cfg.dimensions)).astype(np.float32)
    ids0, d0 = coord.search(q, 5)
    ids1, d1 = loaded.search(q, 5)
    np.testing.assert_array_equal(ids0, ids1)
    np.testing.assert_array_equal(d0, d1)

    loaded.insert([99999], rng.standard_normal((1, cfg.dimensions)).astype(np.float32))
    assert loaded.count == coord.count + 1


@pytest.mark.parametrize("block,offset,garbage", [
    (3, 100, b"\xff\xff\xff\xff"),  # flipped bytes
    (5, None, b"\xa5" * 64),  # a block torn mid-write
])
def test_corrupt_block_is_detected(tmp_path, rng, block, offset, garbage):
    """A block that matches neither its committed nor its staged CRC:
    IndexCorruptionError naming the block, the index marked broken (even
    an unchecked load refuses), and the last resort rebuilds it."""
    _, cfg = both_configs("cosine", None)
    data = rng.standard_normal((30, cfg.dimensions)).astype(np.float32)
    d = tmp_path / "idx"
    checkpoint.save_index(built(cfg, data), d)
    bs = block_codec.resolve_layout(cfg).block_size
    with open(d / "graph.lmd", "r+b") as f:
        f.seek(4096 + block * bs + (bs // 2 if offset is None else offset))
        f.write(garbage)
    with pytest.raises(checkpoint.IndexCorruptionError, match=f"blocks \\[{block}\\]"):
        load(d)
    with pytest.raises(checkpoint.IndexCorruptionError, match="broken"):
        load(d, verify_checksums=False)
    rebuilt = checkpoint.rebuild_from_primary(
        cfg, PrimaryStorageService.from_array(list(range(30)), data),
        list(range(30)), d, device="cpu",
    )
    assert rebuilt.count == 30 and rebuilt.device.type == "cpu"
    clean = load(d)
    assert clean.count == 30
    ids, _ = clean.search(data[11:12], 1)
    assert ids[0, 0] == 11


def test_crash_recovery_replays_deltas(tmp_path, rng):
    _, cfg = both_configs("cosine", None)
    data = rng.standard_normal((30, cfg.dimensions)).astype(np.float32)
    d = tmp_path / "idx"
    checkpoint.save_index(built(cfg, data[:20]), d)
    # Post-checkpoint mutations whose blocks never reached graph.lmd: only
    # their deltas are logged.
    s = ShadowStorageService(d)
    s.log_insert_batch([20, 21], [20, 21])
    s.log_delete_batch([3])
    s.close()

    loaded = load(d)
    assert loaded.needs_recovery and loaded._ever_tombstoned
    primary = PrimaryStorageService.from_array(list(range(30)), data)
    assert checkpoint.recover(loaded, primary, d) == 3
    assert {20, 21} <= set(loaded.allocator.rowid_to_slot)
    assert 3 not in loaded.allocator.rowid_to_slot
    clean = load(d)
    assert not clean.needs_recovery and clean.count == loaded.count


def test_incremental_checkpoint_writes_only_dirty(tmp_path, rng):
    _, cfg = both_configs("cosine", None)
    data = rng.standard_normal((100, cfg.dimensions)).astype(np.float32)
    coord = built(cfg, data)
    d = tmp_path / "idx"
    stats = checkpoint.save_index(coord, d)
    assert not stats["incremental"] and stats["blocks_written"] == 100

    coord.insert([200, 201], rng.standard_normal((2, cfg.dimensions)).astype(np.float32))
    coord.delete([7])
    dirty = int(coord.arrays.dirty_rows.sum())
    stats2 = checkpoint.save_index(coord, d)
    assert stats2["incremental"]
    assert stats2["blocks_written"] == dirty and 0 < dirty < 60, stats2

    loaded = load(d)
    assert loaded.count == coord.count
    q = rng.standard_normal((5, cfg.dimensions)).astype(np.float32)
    ids0, d0 = coord.search(q, 5)
    ids1, d1 = loaded.search(q, 5)
    np.testing.assert_array_equal(ids0, ids1)
    np.testing.assert_array_equal(d0, d1)

    stats3 = checkpoint.save_index(coord, d)  # a no-op save writes nothing
    assert stats3["incremental"] and stats3["blocks_written"] == 0


def test_save_clears_dirty_rows_in_a_copy_while_a_view_is_held(tmp_path, rng):
    """With donate_buffers False a captured view keeps its tensors: the
    save zeroes a copy of dirty_rows, not the view's."""
    _, cfg = both_configs("l2", "int4")
    coord = built(cfg, rng.standard_normal((40, 16)).astype(np.float32))
    view = coord.capture_view()
    coord.donate_buffers = False
    checkpoint.save_index(coord, tmp_path / "idx")
    assert view.arrays.dirty_rows[:40].all()
    assert not coord.arrays.dirty_rows.any()


def test_crash_between_checkpoint_phases_recovers(tmp_path, rng, monkeypatch):
    """Phase 1 written + fsynced, crash before phase 2: blocks match their
    STAGED checksums, so the next load recovers (replaying the deltas)
    instead of reporting corruption; the next save is a full rewrite."""
    _, cfg = both_configs("cosine", None)
    data = rng.standard_normal((40, cfg.dimensions)).astype(np.float32)
    coord = built(cfg, data)
    d = tmp_path / "idx"
    checkpoint.save_index(coord, d)

    coord.shadow_service = ShadowStorageService(d)
    new = rng.standard_normal((1, cfg.dimensions)).astype(np.float32)
    coord.insert([50], new)
    coord.delete([3])

    def crash_commit(self, *a, **k):
        raise RuntimeError("crash before phase 2")

    monkeypatch.setattr(ShadowStorageService, "commit_checkpoint", crash_commit)
    with pytest.raises(RuntimeError, match="crash before phase 2"):
        checkpoint.save_index(coord, d)
    monkeypatch.undo()
    coord.shadow_service.close()

    loaded = load(d)
    assert loaded.needs_recovery
    primary = PrimaryStorageService.from_array([50], new)
    assert checkpoint.recover(loaded, primary, d) >= 1
    assert 50 in loaded.allocator.rowid_to_slot
    assert 3 not in loaded.allocator.rowid_to_slot
    assert not load(d).needs_recovery


def test_checkpoint_multi_chunk_pipeline(tmp_path, rng):
    """A chunk budget of one block: many pipelined chunks in the save, and
    a load in chunks of three blocks reads the same host state as one in a
    single chunk; full and incremental saves round-trip identically."""
    _, cfg = both_configs("cosine", None)
    data = rng.standard_normal((120, cfg.dimensions)).astype(np.float32)
    coord = built(cfg, data)
    d = tmp_path / "idx"
    stats = checkpoint.save_index(coord, d, chunk_bytes=1)
    assert not stats["incremental"] and stats["blocks_written"] == 120
    bs = block_codec.resolve_layout(cfg).block_size
    whole = checkpoint._load_host_state(d)
    parts = checkpoint._load_host_state(d, chunk_bytes=3 * bs)
    assert whole["fields"].keys() == parts["fields"].keys()
    for name, rows in whole["fields"].items():
        np.testing.assert_array_equal(parts["fields"][name], rows, err_msg=name)
    q = rng.standard_normal((4, cfg.dimensions)).astype(np.float32)
    np.testing.assert_array_equal(coord.search(q, 5)[0], load(d).search(q, 5)[0])

    coord.insert([300], rng.standard_normal((1, cfg.dimensions)).astype(np.float32))
    stats2 = checkpoint.save_index(coord, d, chunk_bytes=1)
    assert stats2["incremental"] and stats2["blocks_written"] > 0
    np.testing.assert_array_equal(coord.search(q, 5)[0], load(d).search(q, 5)[0])


class _CrashPoint(Exception):
    pass


class _FaultyBlockFile:
    """Wraps a block file; raises _CrashPoint once the mutation budget is
    spent — process death at an arbitrary write-op boundary."""

    MUTATORS = {"write_blocks", "write_blocks_at", "truncate", "mark_dirty",
                "submit_write", "submit_write_at"}

    def __init__(self, inner, budget_box):
        self._inner = inner
        self._box = budget_box

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name in self.MUTATORS:
            def guarded(*a, **k):
                if self._box[0] <= 0:
                    raise _CrashPoint(name)
                self._box[0] -= 1
                return attr(*a, **k)
            return guarded
        return attr


def test_crash_at_every_write_boundary_recovers(tmp_path, rng, monkeypatch):
    """A crash at any write-op boundary of an incremental checkpoint leaves
    a loadable index (never a corruption report) whose recovery replays the
    delta log to the exact expected membership."""
    _, cfg = both_configs("cosine", None)
    data = rng.standard_normal((40, cfg.dimensions)).astype(np.float32)
    coord = built(cfg, data)
    d0 = tmp_path / "idx"
    checkpoint.save_index(coord, d0)

    coord.shadow_service = ShadowStorageService(d0)
    new_vec = rng.standard_normal((1, cfg.dimensions)).astype(np.float32)
    coord.insert([50], new_vec)
    coord.delete([3])
    coord.shadow_service.close()
    coord.shadow_service = None

    real_open = checkpoint.open_block_file
    box = [0]

    def faulty_open(*a, **k):
        return _FaultyBlockFile(real_open(*a, **k), box)

    want_rowids = (set(range(40)) - {3}) | {50}
    crashed_at = 0
    for budget in range(0, 64):
        dn = tmp_path / f"idx_b{budget}"
        shutil.copytree(d0, dn)
        box[0] = budget
        monkeypatch.setattr(checkpoint, "open_block_file", faulty_open)
        try:
            checkpoint.save_index(coord, dn)
            survived = True
        except _CrashPoint:
            survived = False
            crashed_at = budget
        finally:
            monkeypatch.setattr(checkpoint, "open_block_file", real_open)

        loaded = load(dn)
        if survived:
            assert not loaded.needs_recovery
            assert set(loaded.allocator.rowid_to_slot) == want_rowids
            break
        if loaded.needs_recovery:
            primary = PrimaryStorageService.from_array([50], new_vec)
            assert checkpoint.recover(loaded, primary, dn) >= 1
            assert set(loaded.allocator.rowid_to_slot) == want_rowids
            clean = load(dn)
            assert not clean.needs_recovery
        else:
            # Crash between the phase-2 commit and the clean mark: the
            # checkpoint is already durable, nothing to replay.
            clean = loaded
        assert set(clean.allocator.rowid_to_slot) == want_rowids
        ids, _ = clean.search(data[7:8], 1)
        assert ids[0, 0] == 7
    else:
        pytest.fail("fault budget never let the checkpoint complete")
    assert crashed_at >= 2


def test_recovery_replays_large_backlog_in_batches(tmp_path, rng):
    """A big delta backlog replays in one batched call per run of the log;
    interleaved runs keep their order and duplicates are idempotent."""
    _, cfg = both_configs("cosine", None)
    data = rng.standard_normal((600, cfg.dimensions)).astype(np.float32)
    d = tmp_path / "idx"
    checkpoint.save_index(built(cfg, data[:100]), d)

    s = ShadowStorageService(d)
    s.log_insert_batch(list(range(100, 500)), list(range(100, 500)))
    s.log_delete_batch([7, 9])
    s.log_insert_batch([500, 501, 500], [500, 501, 500])  # a duplicate
    s.log_delete_batch([500])  # a row inserted earlier in the log
    s.close()

    loaded = load(d)
    assert loaded.needs_recovery
    calls = {"insert": 0, "delete": 0}
    orig_insert, orig_delete = loaded.insert, loaded.delete

    def spy_insert(rowids, vectors):
        calls["insert"] += 1
        return orig_insert(rowids, vectors)

    def spy_delete(rowids):
        calls["delete"] += 1
        return orig_delete(rowids)

    loaded.insert, loaded.delete = spy_insert, spy_delete
    primary = PrimaryStorageService.from_array(list(range(600)), data)
    assert checkpoint.recover(loaded, primary, d) == 405
    assert calls == {"insert": 2, "delete": 2}
    assert {499, 501} <= set(loaded.allocator.rowid_to_slot)
    assert not {500, 7} & set(loaded.allocator.rowid_to_slot)
    clean = load(d)
    assert not clean.needs_recovery
    assert clean.count == 100 + 400 + 1 - 2


def test_recover_replays_crash_logged_update(tmp_path, rng):
    """A crash log holding an update (delete r, insert r) re-applies the
    insert half."""
    d = tmp_path / "idx"
    _, cfg = both_configs("l2", None)
    data = rng.standard_normal((40, cfg.dimensions)).astype(np.float32)
    checkpoint.save_index(built(cfg, data), d)

    loaded = load(d)
    new_vec = rng.standard_normal(cfg.dimensions).astype(np.float32) + 25.0
    loaded.pending_deltas = [(0, "delete", 3, None), (1, "insert", 3, None)]
    loaded.needs_recovery = True

    class Primary:
        def get_vectors(self, rows):
            assert list(rows) == [3]
            return new_vec[None, :]

    assert checkpoint.recover(loaded, Primary(), d) == 2
    ids, _ = loaded.search(new_vec[None, :], 1, l_search=64)
    assert ids[0, 0] == 3
    ids2, _ = load(d).search(new_vec[None, :], 1, l_search=64)
    assert ids2[0, 0] == 3


def test_load_after_delete_all(tmp_path, rng):
    """A checkpoint whose every row was deleted (high water > 0, empty
    lookup) loads, searches empty, and takes inserts."""
    d = tmp_path / "idx"
    _, cfg = both_configs("l2", None)
    data = rng.standard_normal((12, cfg.dimensions)).astype(np.float32)
    coord = built(cfg, data)
    coord.delete(list(range(12)))
    checkpoint.save_index(coord, d)

    loaded = load(d)
    assert loaded.count == 0
    ids, _ = loaded.search(data[:2], 3, l_search=32)
    assert (ids == -1).all()
    loaded.insert([100], data[:1])
    ids2, _ = loaded.search(data[:1], 1, l_search=32)
    assert ids2[0, 0] == 100


def test_pending_delta_backlog_triggers_checkpoint(tmp_path, rng):
    """DML past lm_diskann_checkpoint_pending_deltas checkpoints inline,
    clearing the delta log; 0 disables the trigger."""
    from duckdb_lm_diskann_tpu_torch.db.database import connect

    db = connect(str(tmp_path / "db"), device="cpu")
    t = db.create_table("t", {"v": rng.standard_normal((32, 8)).astype(np.float32)})
    db.create_index(
        "idx", t, "v",
        options={"metric": "l2", "r": 4, "l_insert": 8, "l_search": 16},
    )
    db.set_option("lm_diskann_checkpoint_pending_deltas", 10)
    shadow = t.indexes["idx"].index.coordinator.shadow_service
    t.insert({"v": rng.standard_normal((4, 8)).astype(np.float32)})
    assert shadow.pending_count() <= 10  # the build's log already crossed it
    t.insert({"v": rng.standard_normal((12, 8)).astype(np.float32)})
    assert shadow.pending_count() == 0
    db.set_option("lm_diskann_checkpoint_pending_deltas", 0)
    t.insert({"v": rng.standard_normal((12, 8)).astype(np.float32)})
    assert shadow.pending_count() == 12


# --------------------------------------------------------------------- #
# against the JAX package

_BUILT: dict = {}


def _jax_built():
    """(JAX Coordinator, port config, data, queries): a 300-row L2/INT4
    graph the JAX package built (D=16, R=8), once per process."""
    if "graph" not in _BUILT:
        _BUILT["graph"] = jax_graph("l2", "int4", n=300, dims=16)
    return _BUILT["graph"]


def _state_pair(rng, metric, edge_type, node="float32", n=40):
    """A synthetic index state (random vectors, codes and neighbor slots,
    dead slots in the deletion queue and the free list, edges into dead
    slots), set into a JAX Coordinator and carried into a port one."""
    import jax.numpy as jnp

    from duckdb_lm_diskann_tpu.core.coordinator import (
        Coordinator as JaxCoordinator,
    )

    jax_cfg, cfg = both_configs(metric, edge_type, node=node)
    jc = JaxCoordinator(jax_cfg, initial_capacity=n)
    host = {name: np.array(a) for name, a in jc.arrays._asdict().items()}
    vectors, _, kw, _ = _host_rows(rng, cfg, n)
    host["vectors"][:n] = vectors.astype(host["vectors"].dtype)
    nbrs = rng.integers(-1, n, (n, cfg.r)).astype(np.int32)
    host["neighbors"][:n] = nbrs
    dead = [4, 9, 17]
    host["valid"][:n] = True
    host["valid"][dead] = False
    host["dirty_rows"][:n] = True
    et = cfg.resolve_edge_type().value
    if et == "int4":  # the graph holds planar words
        kw["edge_i4"] = i4_planar_from_packed_np(kw["edge_i4"], cfg.dimensions)
    for name, rows in kw.items():
        host[name][:n] = rows.astype(host[name].dtype)
    jc.arrays = type(jc.arrays)(**{k: jnp.asarray(v) for k, v in host.items()})
    live = [s for s in range(n) if s not in dead]
    a = jc.allocator
    a.rowid_to_slot = {3 * s: s for s in live}  # row 0 is slot 0
    a.slot_to_rowid = {s: 3 * s for s in live}
    a.high_water, a.free_slots, a.pending_deletion = n, [4], [9, 17]
    jc._slot_rowids = np.full(jc.capacity, -1, np.int64)
    jc._slot_rowids[live] = 3 * np.asarray(live)
    jc.entry_slot, jc.entry_rowid = 0, 0
    jc._ever_tombstoned = True
    jc.dirty = True
    return jc, port_coordinator_from_jax(jc, cfg)


def _assert_same_files(dir_a, dir_b):
    assert (dir_a / "graph.lmd").read_bytes() == (dir_b / "graph.lmd").read_bytes()
    sa, sb = ShadowStorageService(dir_a), ShadowStorageService(dir_b)
    try:
        assert sa.load_checksums() == sb.load_checksums()
        assert sa.load_lookup() == sb.load_lookup()
        assert sa.load_tombstones() == sb.load_tombstones()
        for key in ("config", "entry_rowid", "count", "high_water",
                    "free_slots", "format_version"):
            assert sa.get_metadata(key) == sb.get_metadata(key), key
    finally:
        sa.close()
        sb.close()


@pytest.mark.parametrize("metric,edge_type,node", [
    *[(m, c, "float32") for m, c in CODECS], ("l2", "int8", "int8"),
], ids=[*CODEC_IDS, "int8-int8nodes"])
def test_same_state_saves_the_same_files_and_cross_loads(
    tmp_path, rng, metric, edge_type, node
):
    """One index state, saved by each package: byte-identical graph.lmd,
    identical CRCs and metadata; each checkpoint opens in the other
    package with every table, map and entry identical."""
    from duckdb_lm_diskann_tpu.store import checkpoint as jax_checkpoint

    jc, pc = _state_pair(rng, metric, edge_type, node)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    want = jax_checkpoint.save_index(jc, jax_dir)
    got = checkpoint.save_index(pc, port_dir)
    assert got == {**want, "backend": "native"}
    assert got["blocks_written"] == 40
    _assert_same_files(jax_dir, port_dir)
    # The JAX package's checkpoint in the port, the port's in JAX.
    assert_same_state(jax_checkpoint.load_index(port_dir), load(jax_dir))
    assert_same_state(jax_checkpoint.load_index(jax_dir), load(port_dir))


def test_jax_built_graph_saves_the_same_and_cross_loads(tmp_path):
    """A graph the JAX package built: both packages save it to the same
    files; the JAX checkpoint reopens in the port identically and answers
    as the state carried across does."""
    from duckdb_lm_diskann_tpu.store import checkpoint as jax_checkpoint

    jc0, cfg, _, queries = _jax_built()
    jc = jax_coordinator_copy(jc0)
    pc = port_coordinator_from_jax(jc, cfg)
    jax_checkpoint.save_index(jc, tmp_path / "jax")
    checkpoint.save_index(pc, tmp_path / "port")
    _assert_same_files(tmp_path / "jax", tmp_path / "port")
    loaded = load(tmp_path / "jax")
    assert_same_state(jax_checkpoint.load_index(tmp_path / "jax"), loaded)
    want_ids, want_d = pc.search(queries, 5)
    got_ids, got_d = loaded.search(queries, 5)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_d, want_d)


def test_port_checkpoint_after_churn_opens_in_jax(tmp_path):
    """The port deletes and inserts on the JAX-built graph (tombstones, a
    dead entry point, zombie edges), saves, and the JAX package reopens
    the checkpoint with every table, map and entry of the port's reopen;
    the reopened index answers as the saved one."""
    from duckdb_lm_diskann_tpu.store import checkpoint as jax_checkpoint

    jc, cfg, data, queries = _jax_built()
    pc = port_coordinator_from_jax(jax_coordinator_copy(jc), cfg)
    pc.delete([pc.entry_rowid] + list(range(0, 300, 13)))
    pc.insert([1000, 1001, 1002], data[:3] + 0.5)
    checkpoint.save_index(pc, tmp_path / "idx")
    loaded = load(tmp_path / "idx")
    assert_same_state(jax_checkpoint.load_index(tmp_path / "idx"), loaded)
    assert loaded.entry_rowid == pc.entry_rowid
    np.testing.assert_array_equal(loaded.search(queries, 5)[0], pc.search(queries, 5)[0])


def test_delta_log_matches_jax(tmp_path, monkeypatch):
    """The same insert / delete / update sequence logs the same deltas
    (sequence, op, row, slot) in both packages' shadow stores, and leaves
    the same state; a snapshot carries no delta log, and an insert that
    rolls back logs nothing (the JAX Coordinator raises before its log)."""
    jc0, cfg, data, _ = _jax_built()
    jc = jax_coordinator_copy(jc0)
    pc = port_coordinator_from_jax(jc, cfg)
    jc.shadow_service = JaxShadow(tmp_path / "jax")
    pc.shadow_service = ShadowStorageService(tmp_path / "port")
    for coord in (jc, pc):
        coord.insert([1000, 1001], data[:2] + 0.5)
        coord.delete([5, 1000, 99999])
        coord.update(7, data[7] + 0.1)
    want = jc.shadow_service.pending_deltas()
    assert pc.shadow_service.pending_deltas() == want
    assert [op for _, op, _, _ in want] == [
        "insert", "insert", "delete", "delete", "delete", "insert"]
    assert_same_state(jc, pc)
    assert pc.snapshot().shadow_service is None

    def fail(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(port_coord_mod, "insert_batch", fail)
    with pytest.raises(RuntimeError, match="injected"):
        pc.insert([2000], data[:1])
    assert pc.shadow_service.pending_deltas() == want
    jc.shadow_service.close()
    pc.shadow_service.close()


# --------------------------------------------------------------------- #
# on the card


@pytest.mark.cuda
def test_checkpoint_on_the_card(tmp_path):
    """An index saved on the card reopens on the card with identical
    tables and answers; a CPU-built checkpoint opens on the card and
    answers the CPU index's ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(8)
    _, cfg = configs(metric="l2", edge_type="int4", dims=24, r=12,
                     l_insert=24, l_search=128)
    data = rng.standard_normal((500, 24)).astype(np.float32)
    queries = data[:32] + 0.01
    card = Coordinator(cfg, device="cuda")
    card.bulk_build(range(500), data)
    card.delete(list(range(0, 500, 17)))
    checkpoint.save_index(card, tmp_path / "card")
    reopened = checkpoint.load_index(tmp_path / "card")
    assert reopened.device.type == "cuda"
    hw = card.allocator.high_water
    live = card.arrays.valid[:hw]
    for name in ("vectors", "edge_i4", "edge_scale", "valid"):
        a, b = getattr(card.arrays, name)[:hw], getattr(reopened.arrays, name)[:hw]
        assert torch.equal(a[live], b[live]), name
    np.testing.assert_array_equal(
        reopened.search(queries, 10)[0], card.search(queries, 10)[0])

    cpu = Coordinator(cfg, device="cpu")
    cpu.bulk_build(range(500), data)
    checkpoint.save_index(cpu, tmp_path / "cpu")
    on_card = checkpoint.load_index(tmp_path / "cpu")
    assert on_card.device.type == "cuda"
    np.testing.assert_array_equal(
        on_card.search(queries, 10)[0], cpu.search(queries, 10)[0])
