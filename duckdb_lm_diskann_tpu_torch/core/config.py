"""Index configuration, parameter validation, and node-block layout.

The port's own copy of ``duckdb_lm_diskann_tpu/core/config.py`` (the port
imports nothing of the JAX package), with one addition: ``validate`` refuses
enum members that are not the port's own (``common/types.py``), because the
port compares them with ``is`` and a foreign member would silently fall
through every branch.

Re-design of the reference's ``src/lm_diskann/core/index_config.{hpp,cpp}``:

  - defaults METRIC=COSINE(ternary)/R=64/L_INSERT=128/ALPHA=1.2/L_SEARCH=100
    (index_config.hpp:32-38)
  - format version 3 (index_config.hpp:43)
  - ValidateParameters: R>0, L_INSERT>0, ALPHA>=1, L_SEARCH>0, L_INSERT>=R,
    dims>0, vector type known, TERNARY edges incompatible with L2
    (index_config.cpp:66-102)
  - CalculateLayoutInternal: the on-disk node-block layout
    (index_config.cpp:104-148), reproduced bit-compatibly by
    :class:`NodeLayout` for the persistence codec. The *device* layout is a
    struct-of-arrays instead (see core/graph.py) — that is the TPU-first
    re-design: "one block read" becomes "one gather row".

The reference derives dimensions + vector type from the column type, never
from options (db/LmDiskannIndex.cpp:137-154); we mirror that by deriving them
from the input arrays at index creation.
"""

from __future__ import annotations

import dataclasses

from ..common.types import EdgeType, MetricType, VectorType

# --- Defaults (index_config.hpp:32-38) ---
DEFAULT_METRIC = MetricType.COSINE
DEFAULT_R = 64
DEFAULT_L_INSERT = 128
DEFAULT_ALPHA = 1.2
DEFAULT_L_SEARCH = 100

# Format version (index_config.hpp:43)
LMDISKANN_CURRENT_FORMAT_VERSION = 3

# Block alignment: the reference sector-aligns node blocks to
# Storage::SECTOR_SIZE (db/LmDiskannIndex.cpp:160-162); DuckDB's sector size
# is 4096 bytes.
SECTOR_SIZE = 4096

# Node block internal alignments (index_config.cpp:31-36)
NODE_VECTOR_ALIGNMENT = 8
PLANE_ALIGNMENT = 8
ROW_T_ALIGNMENT = 8  # sizeof(duckdb::row_t)
DISKANN_MAX_BLOCK_SZ = 128 * 1024 * 1024


def align_value(value: int, alignment: int) -> int:
    """duckdb::AlignValue — round ``value`` up to a multiple of ``alignment``."""
    return (value + alignment - 1) // alignment * alignment


def words_per_plane_u64(dimensions: int) -> int:
    """Number of 64-bit words in one ternary bit-plane, matching the
    reference's WordsPerPlane (ternary_quantization.hpp): ceil(dims / 64)."""
    if dimensions <= 0:
        raise ValueError("Cannot calculate plane size for 0 dimensions")
    return (dimensions + 63) // 64


def words_per_plane_u32(dimensions: int) -> int:
    """Number of 32-bit words per plane in *device* arrays. TPUs have no
    uint64 vector lanes, so device planes are uint32; to stay bit-compatible
    with the u64 on-disk planes we pad to an even number of u32 words
    (2 * ceil(dims/64)), i.e. a u64 word is its two little-endian u32 halves."""
    return 2 * words_per_plane_u64(dimensions)


def ternary_plane_size_bytes(dimensions: int) -> int:
    """GetTernaryPlaneSizeBytes (index_config.cpp:55-60)."""
    return words_per_plane_u64(dimensions) * 8


def ternary_edge_size_bytes(dimensions: int) -> int:
    """GetTernaryEdgeSizeBytes (index_config.cpp:62-64): pos + neg plane."""
    return 2 * ternary_plane_size_bytes(dimensions)


@dataclasses.dataclass(frozen=True)
class NodeLayout:
    """Byte offsets inside one serialized node block.

    Bit-compatible reproduction of NodeLayoutOffsets + CalculateLayoutInternal
    (index_config.hpp:78-106, index_config.cpp:104-148):

        u16 neighbor count @ 0
        8B-aligned node vector
        row_t-aligned R x int64 neighbor row ids
        8B-aligned R x positive ternary planes
        8B-aligned R x negative ternary planes

    Used only by the persistence codec (store/block_codec.py); the in-HBM
    representation is struct-of-arrays.
    """

    neighbor_count_offset: int
    node_vector_offset: int
    neighbor_ids_offset: int
    neighbor_pos_planes_offset: int
    neighbor_neg_planes_offset: int
    ternary_edge_size_bytes: int
    total_node_size: int
    block_size_bytes: int  # total_node_size sector-aligned


def calculate_layout(config: "LmDiskannConfig") -> NodeLayout:
    """CalculateLayoutInternal (index_config.cpp:104-148) + the sector
    alignment applied by the db adapter (db/LmDiskannIndex.cpp:160-162)."""
    if config.dimensions <= 0 or config.node_vector_type is VectorType.UNKNOWN:
        raise ValueError(
            "calculate_layout requires dimensions and node_vector_type to be set"
        )
    node_vector_size = config.node_vector_type.size_bytes() * config.dimensions

    offset = 2  # u16 neighbor count at offset 0
    offset = align_value(offset, NODE_VECTOR_ALIGNMENT)
    node_vector_offset = offset
    offset += node_vector_size

    offset = align_value(offset, ROW_T_ALIGNMENT)
    neighbor_ids_offset = offset
    offset += config.r * 8  # R x row_t (int64)

    plane_size = ternary_plane_size_bytes(config.dimensions)
    edge_size = ternary_edge_size_bytes(config.dimensions)

    offset = align_value(offset, PLANE_ALIGNMENT)
    pos_planes_offset = offset
    offset += config.r * plane_size

    offset = align_value(offset, PLANE_ALIGNMENT)
    neg_planes_offset = offset
    offset += config.r * plane_size

    total = offset
    block_size = align_value(total, SECTOR_SIZE)
    if block_size > DISKANN_MAX_BLOCK_SZ:
        raise ValueError("Node block size exceeds DISKANN_MAX_BLOCK_SZ")
    return NodeLayout(
        neighbor_count_offset=0,
        node_vector_offset=node_vector_offset,
        neighbor_ids_offset=neighbor_ids_offset,
        neighbor_pos_planes_offset=pos_planes_offset,
        neighbor_neg_planes_offset=neg_planes_offset,
        ternary_edge_size_bytes=edge_size,
        total_node_size=total,
        block_size_bytes=block_size,
    )


@dataclasses.dataclass
class LmDiskannConfig:
    """Per-index configuration. Mirrors core::LmDiskannConfig
    (index_config.hpp:21-38) plus the edge-encoding extension (EdgeType).

    ``dimensions`` and ``node_vector_type`` are "set later" in the reference
    (derived from the column); here they must be set before validation, the
    same rule ValidateParameters enforces (index_config.cpp:82-91).
    """

    metric_type: MetricType = DEFAULT_METRIC
    r: int = DEFAULT_R
    l_insert: int = DEFAULT_L_INSERT
    alpha: float = DEFAULT_ALPHA
    l_search: int = DEFAULT_L_SEARCH
    dimensions: int = 0
    node_vector_type: VectorType = VectorType.UNKNOWN
    # Edge-cache encoding. None -> metric-dependent default resolved by
    # resolve_edge_type(): TERNARY for COSINE/IP (the reference's implicit
    # choice), INT8 for L2 (the reference forbids TERNARY+L2; libSQL uses
    # compressed float edges for L2 — INT8 is our TPU-native equivalent).
    edge_type: EdgeType | None = None
    # Maximum beam-search hops (fixed loop bound on device). The reference's
    # loop runs until the beam has no unvisited candidate; a visit consumes
    # one beam slot and every hop visits one node, so l_search + slack is a
    # true upper bound in practice; we cap defensively.
    max_visits: int = 0  # 0 -> resolved to 4 * l_search
    # Visit budget for the INSERT-path candidate search. libSQL's insert
    # search has no cap (vectordiskann.c:1493-1623, loop bounded only by
    # beam exhaustion); the default 2*L_INSERT is a deliberate throughput
    # deviation — candidate quality saturates well before that and the
    # insert search dominates build time. Raise (e.g. 8*L_INSERT) for
    # strict capless-equivalent libSQL parity; tests/test_build.py verifies
    # the cap never binds there, so the parity claim is real.
    insert_max_visits: int = 0  # 0 -> resolved to 2 * l_insert
    # Beam width of the INSERT-path candidate search in BATCHED builds (the
    # classic DiskANN beam-width generalization): each while_loop iteration
    # visits this many nodes. Measured on TPU v5e (100k x 128d, batch 1024):
    # width 4 builds 2x SLOWER than width 1 — per-iteration cost grows with
    # W*R (candidate merge + beam membership masks) faster than the
    # iteration count shrinks, because whole-batch iterations already
    # amortize fixed overheads at B=1024. Default 1; kept configurable for
    # small-batch / low-latency insert workloads where per-hop overhead
    # dominates. Sequential (batch-1) inserts always run width 1 for exact
    # libSQL visit-order parity.
    insert_beam_width: int = 1
    # Keys the user passed explicitly in WITH (...) — lets the load path
    # distinguish "user demanded r=8" from "r defaulted to 64" when checking
    # options against a persisted config (reopen must not silently change
    # the block layout).
    explicit_keys: frozenset = dataclasses.field(
        default_factory=frozenset, compare=False, repr=False
    )

    def resolve_edge_type(self) -> EdgeType:
        if self.edge_type is not None:
            return self.edge_type
        if self.metric_type is MetricType.L2:
            return EdgeType.INT8
        return EdgeType.TERNARY

    def resolved_max_visits(self) -> int:
        return self.max_visits if self.max_visits > 0 else 4 * self.l_search

    def resolved_insert_max_visits(self) -> int:
        return (
            self.insert_max_visits
            if self.insert_max_visits > 0
            else 2 * self.l_insert
        )

    def validate(self) -> None:
        """ValidateParameters (index_config.cpp:66-102)."""
        for name, value, cls in (
            ("metric_type", self.metric_type, MetricType),
            ("node_vector_type", self.node_vector_type, VectorType),
            ("edge_type", self.resolve_edge_type(), EdgeType),
        ):
            if not isinstance(value, cls):
                raise TypeError(
                    f"LM_DISKANN {name} must be a {cls.__module__}."
                    f"{cls.__name__} member, got {value!r} of "
                    f"{type(value).__module__}"
                )
        if self.r <= 0:
            raise ValueError("LM_DISKANN parameter R must be > 0")
        if self.l_insert <= 0:
            raise ValueError("LM_DISKANN parameter L_INSERT must be > 0")
        if self.alpha < 1.0:
            raise ValueError("LM_DISKANN parameter ALPHA must be >= 1.0")
        if self.l_search <= 0:
            raise ValueError("LM_DISKANN parameter L_SEARCH must be > 0")
        if self.l_insert < self.r:
            raise ValueError(
                f"LM_DISKANN L_INSERT ({self.l_insert}) must be >= R ({self.r})"
            )
        if self.dimensions <= 0:
            raise ValueError(
                "LM_DISKANN dimensions must be set (derived from column type) "
                "and > 0 before validation"
            )
        if self.node_vector_type is VectorType.UNKNOWN:
            raise ValueError(
                "LM_DISKANN node_vector_type must be set (derived from column "
                "type) before validation"
            )
        if self.metric_type is MetricType.HAMMING:
            raise ValueError("Unsupported metric type HAMMING")
        if self.insert_beam_width < 1:
            raise ValueError("LM_DISKANN insert_beam_width must be >= 1")
        # Ternary dot product is not a reliable proxy for L2 distance
        # (index_config.cpp:93-99). The reference rejects L2 outright because
        # its edges are implicitly ternary; we reject only the explicit
        # TERNARY+L2 combination and default L2 to INT8 edges instead.
        if (
            self.metric_type is MetricType.L2
            and self.resolve_edge_type() is EdgeType.TERNARY
        ):
            raise ValueError(
                "LM_DISKANN with TERNARY neighbors is not compatible with "
                "METRIC 'L2'. Use COSINE or IP (or edge_type INT8/FLOAT32)."
            )
        # libSQL's rule verbatim: "1-bit compression available only for
        # cosine metric" (vectordiskann.c:518).
        if (
            self.resolve_edge_type() is EdgeType.FLOAT1BIT
            and self.metric_type is not MetricType.COSINE
        ):
            raise ValueError(
                "1-bit compression available only for cosine metric"
            )


# WITH-option keys accepted by parse_options, mirroring the set parsed in
# db/LmDiskannIndex.cpp:72-110 (METRIC, R, L_INSERT, ALPHA, L_SEARCH) plus the
# EDGE_TYPE extension.
_OPTION_KEYS = {"metric", "r", "l_insert", "alpha", "l_search", "edge_type"}


def parse_options(options: dict | None = None, **kwargs) -> LmDiskannConfig:
    """Parse CREATE INDEX ... WITH (...) style options, case-insensitively,
    mirroring db/LmDiskannIndex.cpp:72-110. Unknown keys raise, like the
    reference's binder error."""
    opts: dict = {}
    for src in (options or {}), kwargs:
        for k, v in src.items():
            opts[str(k).strip().lower()] = v
    config = LmDiskannConfig()
    for key, value in opts.items():
        if key not in _OPTION_KEYS:
            raise ValueError(f"Unknown LM_DISKANN option '{key}'")
        if key == "metric":
            config.metric_type = MetricType.parse(value)
        elif key == "r":
            config.r = int(value)
        elif key == "l_insert":
            config.l_insert = int(value)
        elif key == "alpha":
            config.alpha = float(value)
        elif key == "l_search":
            config.l_search = int(value)
        elif key == "edge_type":
            config.edge_type = EdgeType.parse(value)
    config.explicit_keys = frozenset(opts)
    return config
