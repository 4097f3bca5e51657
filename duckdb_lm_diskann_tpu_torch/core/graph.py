"""The in-GPU-memory graph container: LM-DiskANN node blocks as
struct-of-arrays of torch tensors.

Counterpart of ``duckdb_lm_diskann_tpu/core/graph.py``, with the same ten
fields, shapes and zero-size placeholders:

    vectors    f32[C, D]      node vectors (i8 for INT8 node vectors)
    neighbors  i32[C, R]      neighbor slots, -1 = empty
    valid      bool[C]        live-node mask
    edge_pos   i32[C, R, W]   TERNARY / FLOAT1BIT sign planes, else [C, 0, 0]
    edge_neg   i32[C, R, W]   TERNARY, else [C, 0, 0]
    edge_i8    i8[C, R, D]    INT8, else [C, 0, 0]
    edge_i4    i32[C, R, DW]  INT4 planar words, else [C, 0, 0]
    edge_scale f32[C, R]      INT8 / INT4, else [C, 0]
    edge_f32   f32[C, R, D]   FLOAT32 (f16 for FLOAT16), else [C, 0, 0]
    dirty_rows bool[C]        rows written since the last checkpoint

The JAX package stores the word fields (edge_pos, edge_neg, edge_i4) as
uint32; here they are int32 with the same bits, because torch on the CPU
cannot shift uint32. ``graph_arrays_from_numpy`` and ``GraphArrays.to_numpy``
convert at that boundary.

Where the JAX package returns new arrays from every update (and donates
buffers to reuse memory), the builder here writes these tensors in place.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..common.types import EdgeType, MetricType, VectorType
from ..ops.quantize import words_per_i4
from .config import LmDiskannConfig, words_per_plane_u32

_WORD_FIELDS = ("edge_pos", "edge_neg", "edge_i4")


class GraphArrays(NamedTuple):
    """Device-side graph state; every tensor lives on one device."""

    vectors: torch.Tensor
    neighbors: torch.Tensor
    valid: torch.Tensor
    edge_pos: torch.Tensor
    edge_neg: torch.Tensor
    edge_i8: torch.Tensor
    edge_i4: torch.Tensor
    edge_scale: torch.Tensor
    edge_f32: torch.Tensor
    dirty_rows: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def to_numpy(self) -> "GraphArrays":
        """Host copy with the JAX package's dtypes (word fields as uint32),
        for comparison with ``np.asarray`` of the JAX arrays."""
        out = {}
        for name in self._fields:
            a = getattr(self, name).cpu().numpy()
            out[name] = a.view(np.uint32) if name in _WORD_FIELDS else a
        return GraphArrays(**out)


def graph_arrays_from_numpy(arrays, device) -> GraphArrays:
    """Carry a JAX-built graph across: ``arrays`` has the ten GraphArrays
    fields (for example the JAX package's GraphArrays); each leaf goes
    through ``np.asarray``, uint32 words are reinterpreted as int32, and
    bool/f32/i32/i8 leaves keep their dtype."""
    out = {}
    for name in GraphArrays._fields:
        a = np.asarray(getattr(arrays, name))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        # A copy: the port writes its tensors in place, and must never write
        # through to the caller's (possibly read-only) buffers.
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return GraphArrays(**out)


@dataclasses.dataclass(frozen=True)
class GraphParams:
    """Static parameters of an index (the JAX GraphParams minus its TPU
    dispatch switches)."""

    dims: int
    r: int
    metric: MetricType
    edge_type: EdgeType
    alpha: float
    l_insert: int
    l_search: int
    max_visits: int
    insert_max_visits: int = 0
    insert_beam_width: int = 1
    node_vtype: VectorType = VectorType.FLOAT32

    @classmethod
    def from_config(cls, config: LmDiskannConfig) -> "GraphParams":
        """Parameters of a validated port config. A config of another class
        (the JAX package's) is refused: its enum members are not the port's,
        and ``is`` comparisons would silently fall through."""
        if not isinstance(config, LmDiskannConfig):
            raise TypeError(
                f"expected {LmDiskannConfig.__module__}.LmDiskannConfig, got "
                f"{type(config).__module__}.{type(config).__name__}"
            )
        config.validate()
        return cls(
            dims=config.dimensions,
            r=config.r,
            metric=config.metric_type,
            edge_type=config.resolve_edge_type(),
            alpha=config.alpha,
            l_insert=config.l_insert,
            l_search=config.l_search,
            max_visits=config.resolved_max_visits(),
            insert_max_visits=config.resolved_insert_max_visits(),
            insert_beam_width=config.insert_beam_width,
            node_vtype=config.node_vector_type,
        )

    @property
    def words(self) -> int:
        return words_per_plane_u32(self.dims)

    @property
    def prune_metric(self) -> MetricType:
        """RobustPrune's metric: IP indexes prune in cosine geometry, since
        IP distances can be negative and invert the alpha rule."""
        return MetricType.COSINE if self.metric is MetricType.IP else self.metric


def make_graph_arrays(
    params: GraphParams, capacity: int, device="cpu"
) -> GraphArrays:
    """Allocate zeroed arrays for ``capacity`` node slots on ``device``."""
    d, r, w = params.dims, params.r, params.words
    et = params.edge_type
    tern = et is EdgeType.TERNARY
    pos = tern or et is EdgeType.FLOAT1BIT
    i8 = et is EdgeType.INT8
    i4 = et is EdgeType.INT4
    f32 = et in (EdgeType.FLOAT32, EdgeType.FLOAT16)
    i4w = words_per_i4(d)
    vec_dtype = (
        torch.int8 if params.node_vtype is VectorType.INT8 else torch.float32
    )

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return GraphArrays(
        vectors=zeros((capacity, d), vec_dtype),
        neighbors=torch.full(
            (capacity, r), -1, dtype=torch.int32, device=device
        ),
        valid=zeros((capacity,), torch.bool),
        edge_pos=zeros((capacity, r if pos else 0, w if pos else 0), torch.int32),
        edge_neg=zeros((capacity, r if tern else 0, w if tern else 0), torch.int32),
        edge_i8=zeros((capacity, r if i8 else 0, d if i8 else 0), torch.int8),
        edge_i4=zeros((capacity, r if i4 else 0, i4w if i4 else 0), torch.int32),
        edge_scale=zeros((capacity, r if (i8 or i4) else 0), torch.float32),
        edge_f32=zeros(
            (capacity, r if f32 else 0, d if f32 else 0),
            torch.float16 if et is EdgeType.FLOAT16 else torch.float32,
        ),
        dirty_rows=zeros((capacity,), torch.bool),
    )


def grow_graph_arrays(arrays: GraphArrays, new_capacity: int) -> GraphArrays:
    """Copy into arrays of ``new_capacity`` rows (new neighbor rows are -1,
    everything else zero)."""
    old = arrays.capacity
    if new_capacity <= old:
        return arrays

    def grow(name, a):
        fill = -1 if name == "neighbors" else 0
        tail = torch.full(
            (new_capacity - old,) + tuple(a.shape[1:]), fill,
            dtype=a.dtype, device=a.device,
        )
        return torch.cat([a, tail])

    return GraphArrays(
        **{n: grow(n, getattr(arrays, n)) for n in GraphArrays._fields}
    )


class SlotAllocator:
    """Host-side rowid<->slot bookkeeping (a copy of the JAX package's,
    whose module imports jax, as far as insert and rollback use it). Freed
    slots wait in a pending deletion queue and are not reused: recycling
    them is vacuum's job, not ported yet, so new slots come from the high
    water mark."""

    def __init__(self) -> None:
        self.rowid_to_slot: dict[int, int] = {}
        self.slot_to_rowid: dict[int, int] = {}
        self.pending_deletion: list[int] = []
        self.high_water: int = 0

    @property
    def count(self) -> int:
        return len(self.rowid_to_slot)

    def allocate(self, rowid: int) -> int:
        if rowid in self.rowid_to_slot:
            raise KeyError(f"row id {rowid} already in index")
        slot = self.high_water
        self.high_water += 1
        self.rowid_to_slot[rowid] = slot
        self.slot_to_rowid[slot] = rowid
        return slot

    def allocate_batch(self, rowids) -> np.ndarray:
        """Atomic batch allocation: every rowid is validated before any is
        allocated."""
        rowids = [int(r) for r in rowids]
        seen: set[int] = set()
        for r in rowids:
            if r in self.rowid_to_slot:
                raise KeyError(f"row id {r} already in index")
            if r in seen:
                raise KeyError(f"row id {r} duplicated in batch")
            seen.add(r)
        return np.asarray([self.allocate(r) for r in rowids], np.int32)

    def free(self, rowid: int) -> int:
        """Unmap a row id; its slot joins the deletion queue."""
        slot = self.rowid_to_slot.pop(rowid)
        del self.slot_to_rowid[slot]
        self.pending_deletion.append(slot)
        return slot
