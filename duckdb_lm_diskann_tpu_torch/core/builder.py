"""Vamana graph construction: batched RobustPrune + batched incremental
insert, writing the graph tensors in place.

Counterpart of the build path of ``duckdb_lm_diskann_tpu/core/builder.py``
(see its docstring for the algorithm and its reference line numbers):

  * ``insert_step`` stores the new vectors, searches the pre-batch graph for
    each new node's candidates (L = L_insert), RobustPrunes them into its
    neighbor list, then runs the reciprocal pass — libSQL's replace/prune
    edge insertion into each target, in rounds so that a round touches each
    target once — and the in-link guarantee (force-link rejected newcomers).
  * Batch size 1 keeps the sequential libSQL/oracle semantics: every visited
    node is a reciprocal target, lists stay left-packed, and every changed
    row re-encodes its whole edge-code row.
  * Larger batches reciprocate with the _RECIP_K nearest visited nodes, let
    a target accept at most _RECIP_ROUNDS newcomers, keep holes in place
    and patch one edge code per written (target, slot) pair.

Where the JAX package returns new arrays and donates buffers, the functions
here update ``arrays``' tensors in place and return the same object. Pair
work is chunked only to bound the [pairs, R, D] neighbor-vector gather.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.types import EdgeType
from ..ops import topk as topk_ops
from ..ops.distance import batched_all_pairs_distance, pairwise_distance
from ..ops.quantize import encode_int4, encode_int8
from ..ops.ternary import encode_ternary
from .graph import GraphArrays, GraphParams
from .searcher import search_for_initial_candidates

INF = float("inf")

# Batched-build reciprocal width / per-target rounds / force rounds (the
# JAX builder's values; see its comments for how they were chosen).
_RECIP_K = 32
_RECIP_ROUNDS = 8
_FORCE_ROUNDS = 2

# Bound on one replace step's [pairs, R, D] f32 neighbor-vector gather.
_PAIR_GATHER_BYTES = 1 << 30


_PORTED_EDGE_TYPES = (EdgeType.INT4, EdgeType.TERNARY, EdgeType.INT8)


def require_ported_codec(params: GraphParams) -> None:
    if params.edge_type not in _PORTED_EDGE_TYPES:
        raise NotImplementedError(
            f"edge type {params.edge_type.value} is not ported yet "
            "(ROADMAP queue 1, item 8: the other codecs)"
        )


def _encode_edges(
    arrays: GraphArrays,
    tgt: torch.Tensor,  # i64[T] target rows
    slots: torch.Tensor | None,  # i64[T] edge slot, or None for whole rows
    vecs: torch.Tensor,  # f32[T, R, D] (whole rows) or f32[T, D]
    ok: torch.Tensor | None,  # bool[T, R]: False slots get zero codes
    params: GraphParams,
) -> None:
    """Encode ``vecs`` with the index's codec and write the codes (and
    scales) at ``arrays``' [tgt] rows, or at [tgt, slots] (in place)."""
    et = params.edge_type
    if et is EdgeType.TERNARY:
        fields = dict(zip(("edge_pos", "edge_neg"), encode_ternary(vecs)))
    elif et is EdgeType.INT8:
        fields = dict(zip(("edge_i8", "edge_scale"), encode_int8(vecs)))
    else:
        fields = dict(zip(("edge_i4", "edge_scale"), encode_int4(vecs)))
    for name, val in fields.items():
        if ok is not None:
            mask = ok if val.dim() == ok.dim() else ok[..., None]
            val = torch.where(mask, val, torch.zeros_like(val))
        dest = getattr(arrays, name)
        if slots is None:
            dest[tgt] = val
        else:
            dest[tgt, slots] = val


def batched_robust_prune(
    arrays: GraphArrays,
    node_vecs: torch.Tensor,  # f32[T, D]
    cand_slots: torch.Tensor,  # i32[T, C] candidate slots (-1 invalid)
    self_slots: torch.Tensor,  # i32[T] slot being pruned (-1 ok)
    *,
    params: GraphParams,
) -> torch.Tensor:
    """Vectorized RobustPrune (GraphManager.cpp:259-378). Returns selected
    neighbor slots i32[T, R], -1 padded, in selection order."""
    T, C = cand_slots.shape
    R = params.r
    pm = params.prune_metric
    safe = cand_slots.clamp_min(0).long()
    valid = (
        (cand_slots >= 0)
        & arrays.valid[safe]
        & (cand_slots != self_slots[:, None])
    )
    cand_vecs = arrays.vectors[safe].float()  # [T, C, D]
    d_node = pairwise_distance(node_vecs[:, None, :].float(), cand_vecs, pm)
    d_node, slot_key = topk_ops.mask_invalid(d_node, cand_slots, valid)
    order0 = torch.arange(C, device=cand_slots.device).expand(T, C)
    d_sorted, slot_sorted, perm = topk_ops.sort_by_distance_id(
        d_node, slot_key, order0
    )
    d_sorted, slot_sorted = topk_ops.dedup_sorted_ids(d_sorted, slot_sorted)
    vec_sorted = cand_vecs.gather(
        1, perm[..., None].expand(-1, -1, cand_vecs.shape[-1])
    )
    ok = slot_sorted >= 0
    d_pair = batched_all_pairs_distance(vec_sorted, pm)  # [T, C, C]

    rows = torch.arange(T, device=cand_slots.device)
    pruned = ~ok  # invalid candidates start pruned
    selected = torch.zeros_like(ok)
    sel_idx = torch.full((T, R), -1, dtype=torch.int64, device=ok.device)
    for s in range(R):
        avail = ok & ~pruned & ~selected
        has = avail.any(-1)
        first = avail.to(torch.uint8).argmax(-1)  # first in sorted order
        sel_idx[:, s] = torch.where(has, first, -1)
        selected[rows, first] |= has
        # alpha * d(p, r_new) < d(node, p) => prune p (strict '<',
        # GraphManager.cpp:357-361).
        d_row = d_pair[rows, first]  # [T, C]
        pruned |= (params.alpha * d_row < d_sorted) & has[:, None]
    sel = slot_sorted.gather(1, sel_idx.clamp_min(0))
    return torch.where(sel_idx >= 0, sel, torch.full_like(sel, -1))


def write_neighbor_rows(
    arrays: GraphArrays,
    target_slots: torch.Tensor,  # i32[T] (-1 rows are skipped)
    nbr_slots: torch.Tensor,  # i32[T, R] (-1 padded)
    *,
    params: GraphParams,
) -> GraphArrays:
    """Set the neighbor list and cached edge codes of each target row (in
    place); empty slots get zero codes and zero scales. Targets must be
    unique."""
    require_ported_codec(params)
    keep = target_slots >= 0
    tgt = target_slots[keep].long()
    nbr = nbr_slots[keep]
    nbr_vecs = arrays.vectors[nbr.clamp_min(0).long()].float()  # [T, R, D]
    arrays.neighbors[tgt] = nbr
    arrays.dirty_rows[tgt] = True
    _encode_edges(arrays, tgt, None, nbr_vecs, nbr >= 0, params)
    return arrays


def store_vectors(
    arrays: GraphArrays, slots: torch.Tensor, vecs: torch.Tensor
) -> GraphArrays:
    """Store node vectors and mark the slots live with empty neighbor lists
    (AddNode steps 1-3, GraphManager.cpp:73-113). Slots < 0 are skipped."""
    keep = slots >= 0
    idx = slots[keep].long()
    v = vecs[keep]
    if arrays.vectors.dtype == torch.int8:
        stored = torch.clamp(torch.round(v.float()), -128, 127).to(torch.int8)
    else:
        stored = v.to(arrays.vectors.dtype)
    arrays.vectors[idx] = stored
    arrays.valid[idx] = True
    arrays.neighbors[idx] = -1
    arrays.dirty_rows[idx] = True
    return arrays


def _rank_within_group(keys: torch.Tensor) -> torch.Tensor:
    """0-based rank of each element within its run of equal keys, for
    ascending-sorted keys [P]."""
    P = keys.shape[0]
    idx = torch.arange(P, device=keys.device)
    is_first = torch.ones(P, dtype=torch.bool, device=keys.device)
    is_first[1:] = keys[1:] != keys[:-1]
    run_start = torch.cummax(torch.where(is_first, idx, 0), 0).values
    return idx - run_start


def replace_edge_lists(
    vectors: torch.Tensor,  # [C, D]
    neighbors: torch.Tensor,  # i32[C, R] the neighbor table (updated in place)
    tgt: torch.Tensor,  # i32[U] unique target slots (-1 padded)
    new_c: torch.Tensor,  # i32[U] one new candidate per target
    params: GraphParams,
    compact: bool = True,
):
    """libSQL's incremental edge insertion (diskAnnReplaceEdgeIdx +
    diskAnnPruneEdges, vectordiskann.c:1176-1280), vectorized over U
    targets:

      - a candidate already in the list is overwritten in place;
      - it is skipped if an existing edge e dominates it,
        d(t,c) > alpha * d(e,c);
      - else it takes the first empty slot, or replaces the edge with the
        largest d(t,e) among those with d(t,e) > d(t,c) (first on ties);
      - afterwards edges with d(t,e) > alpha * d(c,e) are evicted.

    ``compact`` left-packs the list after eviction (sequential/parity
    form); without it holes stay in place, so the written slot stays valid
    for a single edge-code write. Returns (neighbors, accepted mask [U],
    written slot [U])."""
    R = params.r
    alpha = params.alpha
    pm = params.prune_metric
    valid_t = (tgt >= 0) & (new_c >= 0) & (tgt != new_c)
    t_safe = tgt.clamp_min(0).long()
    t_vec = vectors[t_safe].float()  # [U, D]
    c_vec = vectors[new_c.clamp_min(0).long()].float()  # [U, D]
    nbr = neighbors[t_safe]  # [U, R]
    present = nbr >= 0
    nbr_vecs = vectors[nbr.clamp_min(0).long()].float()  # [U, R, D]

    inf = torch.full(nbr.shape, INF, device=nbr.device)
    d_tc = pairwise_distance(t_vec, c_vec, pm)  # [U]
    d_te = torch.where(
        present, pairwise_distance(t_vec[:, None, :], nbr_vecs, pm), inf
    )
    d_ec = torch.where(
        present, pairwise_distance(c_vec[:, None, :], nbr_vecs, pm), inf
    )

    is_c = nbr == new_c[:, None]
    already = is_c.any(-1)
    already_idx = is_c.to(torch.uint8).argmax(-1)
    dominated = (present & (d_tc[:, None] > alpha * d_ec)).any(-1)
    empty = ~present
    has_empty = empty.any(-1)
    first_empty = empty.to(torch.uint8).argmax(-1)
    repl_ok = present & (d_te > d_tc[:, None])
    repl_has = repl_ok.any(-1)
    repl_idx = torch.where(repl_ok, d_te, -inf).argmax(-1)

    slot = torch.where(
        already, already_idx, torch.where(has_empty, first_empty, repl_idx)
    )
    do = valid_t & (already | (~dominated & (has_empty | repl_has)))

    cols = torch.arange(R, device=nbr.device)[None, :]
    at_slot = cols == slot[:, None]
    evict = present & ~at_slot & (d_te > alpha * d_ec) & do[:, None]
    new_nbr = torch.where(evict, torch.full_like(nbr, -1), nbr)
    new_nbr = torch.where(
        at_slot & do[:, None], new_c[:, None].expand_as(nbr), new_nbr
    )
    if compact:
        # Stable left-pack (libSQL's nodeBinDeleteEdge keeps edges
        # contiguous).
        _, order = torch.sort((new_nbr < 0).to(torch.uint8), dim=-1, stable=True)
        new_nbr = new_nbr.gather(-1, order)
    neighbors[tgt[do].long()] = new_nbr[do]
    return neighbors, do, slot.to(torch.int32)


def force_edge_lists(
    vectors: torch.Tensor,  # [C, D]
    neighbors: torch.Tensor,  # i32[C, R] (updated in place)
    tgt: torch.Tensor,  # i32[U] (-1 padded)
    new_c: torch.Tensor,  # i32[U]
    params: GraphParams,
):
    """Unconditional edge insertion — first empty slot, else replace the
    farthest edge: the in-link guarantee for newcomers every target
    rejected. Returns (neighbors, written slot [U], applied [U])."""
    R = params.r
    valid_t = (tgt >= 0) & (new_c >= 0) & (tgt != new_c)
    t_safe = tgt.clamp_min(0).long()
    nbr = neighbors[t_safe]
    present = nbr >= 0
    already = (nbr == new_c[:, None]).any(-1)
    nbr_vecs = vectors[nbr.clamp_min(0).long()].float()
    d_te = torch.where(
        present,
        pairwise_distance(
            vectors[t_safe].float()[:, None, :], nbr_vecs, params.prune_metric
        ),
        torch.full(nbr.shape, -INF, device=nbr.device),
    )
    empty = ~present
    has_empty = empty.any(-1)
    first_empty = empty.to(torch.uint8).argmax(-1)
    worst = d_te.argmax(-1)
    slot = torch.where(has_empty, first_empty, worst)
    do = valid_t & ~already
    cols = torch.arange(R, device=nbr.device)[None, :]
    new_nbr = torch.where(
        (cols == slot[:, None]) & do[:, None], new_c[:, None].expand_as(nbr), nbr
    )
    neighbors[tgt[do].long()] = new_nbr[do]
    return neighbors, slot.to(torch.int32), do


def write_single_edge_codes(
    arrays: GraphArrays,
    tgts: torch.Tensor,  # i32[P] target slots
    slots: torch.Tensor,  # i32[P] edge slot within the target's row
    cand_vecs: torch.Tensor,  # f32[P, D] the new edge's vector
    ok: torch.Tensor,  # bool[P]
    *,
    params: GraphParams,
) -> GraphArrays:
    """Write one cached edge code per (target, slot) pair (in place). Pairs
    must be unique within one call."""
    require_ported_codec(params)
    t = tgts[ok].long()
    s = slots[ok].clamp_min(0).long()
    _encode_edges(arrays, t, s, cand_vecs[ok], None, params)
    arrays.dirty_rows[t] = True
    return arrays


def refresh_edge_codes(
    arrays: GraphArrays, tgts: torch.Tensor, *, params: GraphParams
) -> GraphArrays:
    """Re-encode the cached edge codes of ``tgts`` (unique, -1 padded) from
    their current neighbor lists."""
    return write_neighbor_rows(
        arrays, tgts, arrays.neighbors[tgts.clamp_min(0).long()], params=params
    )


def _pair_chunk(r: int, d: int) -> int:
    return max(_PAIR_GATHER_BYTES // max(r * d * 4, 1), 256)


def insert_step(
    arrays: GraphArrays,
    new_slots: torch.Tensor,  # i32[M] pre-allocated slots
    new_vecs: torch.Tensor,  # f32[M, D]
    entry_slot: int,
    *,
    params: GraphParams,
    full_visited: bool,
    recip_rounds: int,
    all_valid: bool = False,
) -> GraphArrays:
    """One whole batched insert, in place: store, candidate search, prune,
    neighbor write, reciprocal rounds, in-link guarantee and the edge-code
    writes."""
    M = new_slots.shape[0]
    dev = new_slots.device
    vectors = arrays.vectors
    neighbors = arrays.neighbors
    cap = arrays.capacity
    store_vectors(arrays, new_slots, new_vecs)
    # Pass 1: search the pre-batch graph (new slots are unreachable, so the
    # caller's no-tombstones assertion holds), prune over the FULL visited
    # set (vectordiskann.c:1571-1586), write the new rows.
    res = search_for_initial_candidates(
        arrays,
        new_vecs,
        entry_slot,
        params=params,
        l_insert=params.l_insert,
        beam_width=1 if full_visited else params.insert_beam_width,
        assume_all_valid=all_valid,
    )
    sel = batched_robust_prune(
        arrays, new_vecs, res.visited_slots, new_slots, params=params
    )
    write_neighbor_rows(arrays, new_slots, sel, params=params)

    # Pass 2: reciprocal pairs (target, source), grouped by target; a
    # pair's rank within its target's group is the round that applies it.
    if full_visited:
        recip = res.visited_slots  # [1, V]
    else:
        recip = res.topk_slots[:, : min(_RECIP_K, params.l_insert)]
    K = recip.shape[1]
    src = new_slots.repeat_interleave(K)
    tgt = recip.reshape(-1)
    ok = (tgt >= 0) & (src >= 0) & (tgt != src)
    big = cap + 1
    tgt_key = torch.where(ok, tgt, big)
    tgt_s, src_s = topk_ops.lex_sort((tgt_key, src))
    rank = _rank_within_group(tgt_s)
    pair_ok = tgt_s < big

    accepted = torch.zeros(cap, dtype=torch.bool, device=dev)
    changed = torch.zeros(cap, dtype=torch.bool, device=dev)
    chunk = _pair_chunk(params.r, params.dims)
    for r in range(recip_rounds):
        # Within a round every target appears once, so its pairs commute.
        idx = torch.nonzero(pair_ok & (rank == r)).squeeze(1)
        if idx.numel() == 0:
            break  # ranks are dense: no pair has a higher rank either
        for part in idx.split(chunk):
            t_r, c_r = tgt_s[part], src_s[part]
            _, do, w_slot = replace_edge_lists(
                vectors, neighbors, t_r, c_r, params,
                # Sequential inserts keep libSQL's left-packed lists;
                # batched builds keep holes so w_slot stays valid.
                compact=full_visited,
            )
            accepted[c_r[do].long()] = True
            changed[t_r[do].long()] = True
            if not full_visited:
                write_single_edge_codes(
                    arrays, t_r, w_slot, vectors[c_r.long()].float(), do,
                    params=params,
                )

    # In-link guarantee: force-link each rejected newcomer at its nearest
    # selected neighbor; duplicate force targets resolve by rank.
    acc_new = accepted[new_slots.clamp(0, cap - 1).long()] | (new_slots < 0)
    nearest = sel[:, 0]
    orphan = ~acc_new & (nearest >= 0) & (new_slots >= 0)
    t_fs, c_fs = topk_ops.lex_sort(
        (torch.where(orphan, nearest, big), new_slots)
    )
    rank_f = _rank_within_group(t_fs)
    f_ok = t_fs < big
    for r in range(min(_FORCE_ROUNDS, M)):
        idx = torch.nonzero(f_ok & (rank_f == r)).squeeze(1)
        if idx.numel() == 0:
            break
        t_r, c_r = t_fs[idx], c_fs[idx]
        _, w_slot, f_do = force_edge_lists(vectors, neighbors, t_r, c_r, params)
        if not full_visited:
            write_single_edge_codes(
                arrays, t_r, w_slot, vectors[c_r.long()].float(), f_do,
                params=params,
            )

    if full_visited:
        # Compacted lists move slot positions: every changed target and
        # every force target re-encodes its whole row.
        refresh = torch.unique(
            torch.cat([torch.nonzero(changed).squeeze(1), t_fs[f_ok].long()])
        )
        refresh_edge_codes(arrays, refresh.to(torch.int32), params=params)
    return arrays


def insert_batch(
    arrays: GraphArrays,
    new_slots: np.ndarray,  # i32[M] pre-allocated slots
    new_vecs: np.ndarray,  # f32[M, D]
    entry_slot: int,
    params: GraphParams,
    all_valid: bool = False,
) -> GraphArrays:
    """Insert a batch of nodes (in place). The caller owns slot allocation
    and capacity growth. A first insert into an empty graph (entry < 0) must
    be a single node, which becomes the entry point with no edges."""
    dev = arrays.device
    M = len(new_slots)
    slots = torch.as_tensor(np.asarray(new_slots, np.int32), device=dev)
    vecs = torch.as_tensor(np.asarray(new_vecs, np.float32), device=dev)
    if entry_slot < 0:
        if M == 1:
            return store_vectors(arrays, slots, vecs)
        raise ValueError("first insert into an empty graph must be a single node")
    # Batch 1 keeps sequential/libSQL parity: full visited set, one round.
    full = M == 1
    return insert_step(
        arrays, slots, vecs, entry_slot,
        params=params,
        full_visited=full,
        recip_rounds=1 if full else _RECIP_ROUNDS,
        all_valid=all_valid,
    )


def build_schedule(n: int, max_batch: int = 1024) -> list[int]:
    """Ramped batch sizes 1,1,2,4,... so early nodes are inserted with
    near-sequential semantics while the bulk runs at full batch width."""
    out = []
    b = 1
    remaining = n
    while remaining > 0:
        step = min(b, remaining, max_batch)
        out.append(step)
        remaining -= step
        if b < max_batch:
            b *= 2
    return out
