"""Common enums and small type helpers.

The port's own copy of ``duckdb_lm_diskann_tpu/common/types.py`` (the port
imports nothing of the JAX package). Re-design of the reference's
``src/lm_diskann/common/ann.hpp``:
  - ``LmDiskannMetricType{L2, COSINE, IP, HAMMING}``  (ann.hpp:16-24)
  - ``LmDiskannVectorType{FLOAT32, INT8}``            (ann.hpp:26-32)
  - ``ConvertRawVectorToFloat``                       (ann.hpp:42-62)

These enums are distinct classes from the JAX package's: the port compares
members with ``is``, so ``LmDiskannConfig.validate`` refuses members of any
other enum class.

Unlike the reference (raw byte pointers), vectors here are numpy arrays or
torch tensors; conversion helpers therefore operate on arrays, not pointers.
"""

from __future__ import annotations

import enum

import numpy as np

# The reference uses duckdb::row_t (int64) row identifiers and
# NumericLimits<row_t>::Maximum() as the invalid/empty sentinel
# (src/lm_diskann/core/GraphManager.cpp:155). We use -1 for the device-side
# *slot* sentinel (int32 arrays) and INVALID_ROW_ID for 64-bit row ids.
INVALID_ROW_ID: int = -1
INVALID_SLOT: int = -1


class MetricType(enum.Enum):
    """Distance metric. Mirrors common::LmDiskannMetricType (ann.hpp:16-24)."""

    L2 = "l2"
    COSINE = "cosine"
    IP = "ip"
    # HAMMING exists in the reference enum but has no kernel anywhere in the
    # reference; we keep the name for config parity and reject it at
    # validation time, exactly like the reference would fail in
    # ComputeExactDistanceFloat (distance.hpp:100-103).
    HAMMING = "hamming"

    @classmethod
    def parse(cls, value: "str | MetricType") -> "MetricType":
        """Case-insensitive parse, mirroring the reference's WITH-option
        parsing (db/LmDiskannIndex.cpp:72-110 parses METRIC case-insensitively).
        Accepts a few spelling aliases used across the reference bodies
        (hnsw uses 'l2sq'/'cos'/'ip', libSQL uses 'cosine'/'l2')."""
        if isinstance(value, cls):
            return value
        v = str(value).strip().lower()
        aliases = {
            "l2": cls.L2,
            "l2sq": cls.L2,
            "euclidean": cls.L2,
            "cosine": cls.COSINE,
            "cos": cls.COSINE,
            "ip": cls.IP,
            "innerproduct": cls.IP,
            "inner_product": cls.IP,
            "hamming": cls.HAMMING,
        }
        if v not in aliases:
            raise ValueError(
                f"Unknown metric '{value}'. Expected one of: l2, cosine, ip."
            )
        return aliases[v]


class VectorType(enum.Enum):
    """Node-vector element type. Mirrors common::LmDiskannVectorType
    (ann.hpp:26-32); derived from the column type in the reference
    (db/LmDiskannIndex.cpp:137-154), here derived from the array dtype."""

    FLOAT32 = "float32"
    INT8 = "int8"
    UNKNOWN = "unknown"

    @classmethod
    def from_dtype(cls, dtype) -> "VectorType":
        dt = np.dtype(dtype)
        if dt == np.float32:
            return cls.FLOAT32
        if dt == np.int8:
            return cls.INT8
        return cls.UNKNOWN

    def dtype(self):
        if self is VectorType.FLOAT32:
            return np.float32
        if self is VectorType.INT8:
            return np.int8
        raise ValueError("UNKNOWN vector type has no dtype")

    def size_bytes(self) -> int:
        """Mirrors GetVectorTypeSizeBytes (index_config.cpp:40-50)."""
        if self is VectorType.FLOAT32:
            return 4
        if self is VectorType.INT8:
            return 1
        raise ValueError(
            "Unsupported or UNKNOWN LmDiskannVectorType for size calculation"
        )


class EdgeType(enum.Enum):
    """How neighbor vectors are cached inside a node's own block.

    The reference's V2 core implicitly uses TERNARY edges
    (index_config.cpp:93-99); libSQL supports several compression types
    (FLOAT32/FLOAT16/FLOAT8/FLOAT1BIT, vectorIndexInt.h:150-157) and the
    earlier monolithic port enumerates SAME_AS_NODE/F32/F16/INT8/FLOAT1BIT
    (libsql/lm_diskann.hpp:56-62). Supported here:

      TERNARY   - 2 sign bit-planes, popcount dot (cos/IP only, like the ref)
      INT8      - per-edge abs-max scaled int8 (works for all metrics)
      INT4      - per-edge abs-max scaled 4-bit codes, two per byte: half the
                  HBM and half the gather bandwidth of INT8 (works for all
                  metrics; still finer than the reference's 2-bit ternary).
                  The TPU-native choice for large L2 indexes — at 1M x R=64
                  x 128d the INT8 edge cache alone is ~8 GB
      FLOAT32   - uncompressed copy (works for all metrics)
      FLOAT16   - half-precision copy (libSQL F16, lm_diskann.hpp:58; works
                  for all metrics, half FLOAT32's HBM/gather bandwidth)
      FLOAT1BIT - 1 sign bit per dimension (libSQL FLOAT1BIT,
                  lm_diskann.hpp:61); cosine only, exactly libSQL's rule
                  ("1-bit compression available only for cosine metric",
                  vectordiskann.c:518). The libSQL monolithic port left its
                  distance a FIXME (lm_diskann.cpp:900-902); here it is a
                  real XOR+popcount signed dot
      NONE      - no cached edge vectors; traversal gathers neighbor vectors
                  and scores them exactly (the C++ core Searcher's behavior,
                  core/Searcher.cpp:168-173)
    """

    TERNARY = "ternary"
    INT8 = "int8"
    INT4 = "int4"
    FLOAT32 = "float32"
    FLOAT16 = "float16"
    FLOAT1BIT = "float1bit"
    NONE = "none"

    @classmethod
    def parse(cls, value: "str | EdgeType") -> "EdgeType":
        if isinstance(value, cls):
            return value
        v = str(value).strip().lower()
        for m in cls:
            if m.value == v:
                return m
        raise ValueError(f"Unknown edge type '{value}'")


def convert_to_float(vec: np.ndarray) -> np.ndarray:
    """Array analog of ConvertRawVectorToFloat (common/ann.hpp:42-62) /
    ConvertToFloat (core/distance.hpp:28-37): widen int8 (or anything else)
    to float32 without scaling."""
    return np.asarray(vec, dtype=np.float32)
