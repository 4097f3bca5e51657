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

The lifecycle's device work is here too: ``delete_repair_round`` (each
live neighbor of a deleted node re-prunes over its list plus the deleted
node's edges), ``rescue_orphans_round`` (the delete path's in-link
guarantee) and the host planning of both (``plan_delete_repair``), with the
reachability repair's helpers (``reachable_mask``, ``choose_adopters``) and
``select_fallback_entry``.

Where the JAX package returns new arrays and donates buffers, the functions
here update ``arrays``' tensors in place and return the same object. The
insert path's writers take an ``UndoJournal`` that saves every row before
it is overwritten, so that a failed step rolls back exactly. Pair and
repair work is chunked only to bound the [pairs, R, D] neighbor-vector
gathers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.types import INVALID_ROW_ID, EdgeType
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


class UndoJournal:
    """The rows a mutation overwrote, for an exact rollback: ``save`` keeps
    a copy of ``tensor[index]`` before the write, ``rollback`` puts the
    copies back in reverse order. The cost is the rows written, not the
    tables."""

    def __init__(self) -> None:
        self._entries: list[tuple[torch.Tensor, tuple, torch.Tensor]] = []

    def save(self, tensor: torch.Tensor, *index: torch.Tensor) -> None:
        if tensor.numel():
            self._entries.append((tensor, index, tensor[index].clone()))

    def rollback(self) -> None:
        while self._entries:
            tensor, index, old = self._entries.pop()
            tensor[index] = old


def _save(journal: UndoJournal | None, tensor, *index) -> None:
    if journal is not None:
        journal.save(tensor, *index)


def _encode_edges(
    arrays: GraphArrays,
    tgt: torch.Tensor,  # i64[T] target rows
    slots: torch.Tensor | None,  # i64[T] edge slot, or None for whole rows
    vecs: torch.Tensor,  # f32[T, R, D] (whole rows) or f32[T, D]
    ok: torch.Tensor | None,  # bool[T, R]: False slots get zero codes
    params: GraphParams,
    journal: UndoJournal | None = None,
) -> None:
    """Encode ``vecs`` with the index's codec and write the codes (and
    scales) at ``arrays``' [tgt] rows, or at [tgt, slots] (in place).
    FLOAT1BIT's sign plane is TERNARY's positive plane; NONE caches
    nothing."""
    et = params.edge_type
    if et is EdgeType.TERNARY:
        fields = dict(zip(("edge_pos", "edge_neg"), encode_ternary(vecs)))
    elif et is EdgeType.INT8:
        fields = dict(zip(("edge_i8", "edge_scale"), encode_int8(vecs)))
    elif et is EdgeType.INT4:
        fields = dict(zip(("edge_i4", "edge_scale"), encode_int4(vecs)))
    elif et is EdgeType.FLOAT32:
        fields = {"edge_f32": vecs}
    elif et is EdgeType.FLOAT16:
        fields = {"edge_f32": vecs.to(torch.float16)}
    elif et is EdgeType.FLOAT1BIT:
        fields = {"edge_pos": encode_ternary(vecs)[0]}
    else:  # EdgeType.NONE
        fields = {}
    for name, val in fields.items():
        if ok is not None:
            mask = ok if val.dim() == ok.dim() else ok[..., None]
            val = torch.where(mask, val, torch.zeros_like(val))
        dest = getattr(arrays, name)
        if slots is None:
            _save(journal, dest, tgt)
            dest[tgt] = val
        else:
            _save(journal, dest, tgt, slots)
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
    journal: UndoJournal | None = None,
) -> GraphArrays:
    """Set the neighbor list and cached edge codes of each target row (in
    place); empty slots get zero codes and zero scales. Targets must be
    unique."""
    keep = target_slots >= 0
    tgt = target_slots[keep].long()
    nbr = nbr_slots[keep]
    nbr_vecs = arrays.vectors[nbr.clamp_min(0).long()].float()  # [T, R, D]
    _save(journal, arrays.neighbors, tgt)
    _save(journal, arrays.dirty_rows, tgt)
    arrays.neighbors[tgt] = nbr
    arrays.dirty_rows[tgt] = True
    _encode_edges(arrays, tgt, None, nbr_vecs, nbr >= 0, params, journal)
    return arrays


def store_vectors(
    arrays: GraphArrays,
    slots: torch.Tensor,
    vecs: torch.Tensor,
    journal: UndoJournal | None = None,
) -> GraphArrays:
    """Store node vectors and mark the slots live with empty neighbor lists
    (AddNode steps 1-3, GraphManager.cpp:73-113). Slots < 0 are skipped.
    INT8 storage rounds half to even and clamps (the identity on genuine
    TINYINT data); every later distance reads the stored values."""
    keep = slots >= 0
    idx = slots[keep].long()
    v = vecs[keep]
    if arrays.vectors.dtype == torch.int8:
        stored = torch.clamp(torch.round(v.float()), -128, 127).to(torch.int8)
    else:
        stored = v.to(arrays.vectors.dtype)
    for dest in (arrays.vectors, arrays.valid, arrays.neighbors,
                 arrays.dirty_rows):
        _save(journal, dest, idx)
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
    journal: UndoJournal | None = None,
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
    rows = tgt[do].long()
    _save(journal, neighbors, rows)
    neighbors[rows] = new_nbr[do]
    return neighbors, do, slot.to(torch.int32)


def force_edge_lists(
    vectors: torch.Tensor,  # [C, D]
    neighbors: torch.Tensor,  # i32[C, R] (updated in place)
    tgt: torch.Tensor,  # i32[U] (-1 padded)
    new_c: torch.Tensor,  # i32[U]
    params: GraphParams,
    journal: UndoJournal | None = None,
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
    rows = tgt[do].long()
    _save(journal, neighbors, rows)
    neighbors[rows] = new_nbr[do]
    return neighbors, slot.to(torch.int32), do


def write_single_edge_codes(
    arrays: GraphArrays,
    tgts: torch.Tensor,  # i32[P] target slots
    slots: torch.Tensor,  # i32[P] edge slot within the target's row
    cand_vecs: torch.Tensor,  # f32[P, D] the new edge's vector
    ok: torch.Tensor,  # bool[P]
    *,
    params: GraphParams,
    journal: UndoJournal | None = None,
) -> GraphArrays:
    """Write one cached edge code per (target, slot) pair (in place). Pairs
    must be unique within one call."""
    t = tgts[ok].long()
    s = slots[ok].clamp_min(0).long()
    _encode_edges(arrays, t, s, cand_vecs[ok], None, params, journal)
    _save(journal, arrays.dirty_rows, t)
    arrays.dirty_rows[t] = True
    return arrays


def refresh_edge_codes(
    arrays: GraphArrays,
    tgts: torch.Tensor,
    *,
    params: GraphParams,
    journal: UndoJournal | None = None,
) -> GraphArrays:
    """Re-encode the cached edge codes of ``tgts`` (unique, -1 padded) from
    their current neighbor lists."""
    return write_neighbor_rows(
        arrays, tgts, arrays.neighbors[tgts.clamp_min(0).long()],
        params=params, journal=journal,
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
    journal: UndoJournal | None = None,
    rec=None,
) -> GraphArrays:
    """One whole batched insert, in place: store, candidate search, prune,
    neighbor write, reciprocal rounds, in-link guarantee and the edge-code
    writes. With a ``journal`` every overwritten row is saved first, so a
    failure anywhere in the step can be rolled back exactly. ``rec`` (a
    ``utils.tracing.Recorder`` or None) records the ``insert.*`` spans of
    each part."""
    M = new_slots.shape[0]
    dev = new_slots.device
    vectors = arrays.vectors
    neighbors = arrays.neighbors
    cap = arrays.capacity
    if rec is not None:
        rec.open("insert.store")
    store_vectors(arrays, new_slots, new_vecs, journal)
    if rec is not None:
        rec.switch("insert.candidates", rows=M)
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
        rec=rec,
    )
    if rec is not None:
        rec.close(visits=res.visited_count)
        rec.open("insert.prune")
    sel = batched_robust_prune(
        arrays, new_vecs, res.visited_slots, new_slots, params=params
    )
    if rec is not None:
        rec.switch("insert.write")
    write_neighbor_rows(arrays, new_slots, sel, params=params, journal=journal)
    if rec is not None:
        rec.switch("insert.reciprocal")

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
                compact=full_visited, journal=journal,
            )
            accepted[c_r[do].long()] = True
            changed[t_r[do].long()] = True
            if not full_visited:
                write_single_edge_codes(
                    arrays, t_r, w_slot, vectors[c_r.long()].float(), do,
                    params=params, journal=journal,
                )

    # In-link guarantee: force-link each rejected newcomer at its nearest
    # selected neighbor; duplicate force targets resolve by rank.
    if rec is not None:
        rec.switch("insert.force")
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
        _, w_slot, f_do = force_edge_lists(
            vectors, neighbors, t_r, c_r, params, journal
        )
        if not full_visited:
            write_single_edge_codes(
                arrays, t_r, w_slot, vectors[c_r.long()].float(), f_do,
                params=params, journal=journal,
            )

    if full_visited:
        # Compacted lists move slot positions: every changed target and
        # every force target re-encodes its whole row.
        if rec is not None:
            rec.switch("insert.refresh")
        refresh = torch.unique(
            torch.cat([torch.nonzero(changed).squeeze(1), t_fs[f_ok].long()])
        )
        refresh_edge_codes(
            arrays, refresh.to(torch.int32), params=params, journal=journal
        )
    if rec is not None:
        rec.close()
    return arrays


def insert_batch(
    arrays: GraphArrays,
    new_slots: np.ndarray,  # i32[M] pre-allocated slots
    new_vecs: np.ndarray,  # f32[M, D]
    entry_slot: int,
    params: GraphParams,
    all_valid: bool = False,
    journal: UndoJournal | None = None,
    rec=None,
) -> GraphArrays:
    """Insert a batch of nodes (in place). The caller owns slot allocation
    and capacity growth. A first insert into an empty graph (entry < 0) must
    be a single node, which becomes the entry point with no edges.
    ``journal`` (see insert_step) records every row the batch overwrites;
    ``rec`` its spans."""
    dev = arrays.device
    M = len(new_slots)
    slots = torch.as_tensor(np.asarray(new_slots, np.int32), device=dev)
    vecs = torch.as_tensor(np.asarray(new_vecs, np.float32), device=dev)
    if entry_slot < 0:
        if M == 1:
            return store_vectors(arrays, slots, vecs, journal)
        raise ValueError("first insert into an empty graph must be a single node")
    # Batch 1 keeps sequential/libSQL parity: full visited set, one round.
    full = M == 1
    return insert_step(
        arrays, slots, vecs, entry_slot,
        params=params,
        full_visited=full,
        recip_rounds=1 if full else _RECIP_ROUNDS,
        all_valid=all_valid,
        journal=journal,
        rec=rec,
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


# --------------------------------------------------------------------- #
# Delete repair and orphan rescue (JAX core/builder.py:192-420). The JAX
# package stacks equal-width repair rounds into one lax.scan dispatch and
# pads every round to a power of two >= 256 to reuse compiled programs;
# here the rounds run one after another, unpadded (padding rows are no-ops,
# so the results are the same).

# Bound on one delete-repair chunk's [T, 2R, D] f32 candidate gather (the
# prune's pairwise block is as large again).
_PRUNE_GATHER_BYTES = 256 << 20


def delete_repair_round(
    arrays: GraphArrays,
    tgt_slots: torch.Tensor,  # i32[T] repair targets, unique
    extra_cands: torch.Tensor,  # i32[T, R] the adjacent deleted node's edges
    del_slots: torch.Tensor,  # i32[Dn] slots being deleted
    *,
    params: GraphParams,
) -> GraphArrays:
    """One delete-repair round (in place): every target (a live neighbor of
    a deleted node) re-prunes its current neighbor list plus the deleted
    node's out-edges, with every deleted slot masked out, and writes the
    result. Targets are unique within a round, so chunks of them are
    independent: a chunk reads and writes only its own rows."""
    chunk = max(
        _PRUNE_GATHER_BYTES // max(2 * params.r * params.dims * 4, 1), 256
    )
    for t, extra in zip(tgt_slots.split(chunk), extra_cands.split(chunk)):
        safe_t = t.clamp_min(0).long()
        cand = torch.cat([arrays.neighbors[safe_t], extra], 1)  # [T, 2R]
        gone = torch.isin(cand, del_slots) | (cand == t[:, None])
        cand = torch.where(gone, torch.full_like(cand, -1), cand)
        sel = batched_robust_prune(
            arrays, arrays.vectors[safe_t].float(), cand, t, params=params
        )
        write_neighbor_rows(arrays, t, sel, params=params)
    return arrays


def inlink_histogram(
    neighbors: torch.Tensor, valid: torch.Tensor, cap: int
) -> torch.Tensor:
    """In-link counts i32[cap + 1]: hist[s] = edges into slot s from valid
    source rows (the last bin takes the empty slots). Over row-sharded
    tables (``parallel/global_graph.py``) each block histograms its own
    rows (their edge targets are global slots already) and the histograms
    are summed: integer counts, so the sum is the single table's."""
    per_block = getattr(neighbors, "per_block", None)
    if per_block is not None:
        hists = per_block(lambda n, v: inlink_histogram(n, v, cap), valid)
        return torch.stack(hists).sum(0, dtype=torch.int32)
    flat = neighbors.reshape(-1)
    src_ok = valid[:, None].expand(neighbors.shape).reshape(-1)
    cnt = (src_ok & (flat >= 0)).to(torch.int32)
    into = torch.where(flat >= 0, flat, cap).long()
    hist = torch.zeros(cap + 1, dtype=torch.int32, device=neighbors.device)
    return hist.index_add_(0, into, cnt)


def rescue_orphans_round(
    arrays: GraphArrays,
    tgt_slots: torch.Tensor,  # i32[T] affected nodes, unique
    sib_slots: torch.Tensor,  # i32[T, R] each node's ex-sibling candidates
    del_slots: torch.Tensor,  # i32[Dn] slots being deleted
    *,
    params: GraphParams,
) -> tuple[GraphArrays, torch.Tensor]:
    """In-link guarantee of the delete path (in place): every affected node
    left with no in-link from a valid row is force-linked from its nearest
    live, non-deleted ex-sibling. Returns (arrays, adopters i32[T]): the
    adopters whose edge codes the caller refreshes, each once (repeats are
    -1). Two adopters' rounds run; an adopter's third orphan waits for the
    next repair."""
    cap = arrays.capacity
    hist = inlink_histogram(arrays.neighbors, arrays.valid, cap)
    t_safe = tgt_slots.clamp_min(0).long()
    t_ok = (tgt_slots >= 0) & arrays.valid[t_safe]
    orphan = t_ok & (hist[tgt_slots.clamp(0, cap).long()] == 0)

    # Nearest live, non-deleted, non-self ex-sibling of each orphan (the
    # distances are taken for the orphans only: every other row adopts
    # nothing).
    adopter = torch.full_like(tgt_slots, -1)
    rows = torch.nonzero(orphan).squeeze(1)
    if rows.numel():
        sibs = sib_slots[rows]
        s_safe = sibs.clamp_min(0).long()
        sib_ok = (sibs >= 0) & arrays.valid[s_safe]
        sib_ok &= ~torch.isin(sibs, del_slots)
        sib_ok &= sibs != tgt_slots[rows][:, None]
        t_vec = arrays.vectors[t_safe[rows]].float()
        s_vec = arrays.vectors[s_safe].float()
        d = torch.where(
            sib_ok,
            pairwise_distance(t_vec[:, None, :], s_vec, params.prune_metric),
            INF,
        )
        best = d.argmin(-1, keepdim=True)  # first index on ties
        pick = sibs.gather(1, best)[:, 0]
        adopter[rows] = torch.where(sib_ok.any(-1), pick, -1)

    # Duplicate adopters resolve by rank within their group.
    big = cap + 1
    a_key = torch.where(adopter >= 0, adopter, big)
    a_s, order = torch.sort(a_key, stable=True)
    t_s = torch.where(adopter >= 0, tgt_slots, -1)[order]
    rank = _rank_within_group(a_s)
    a_s = torch.where(a_s < big, a_s, -1)
    for r in range(2):
        active = (a_s >= 0) & (rank == r)
        if not bool(active.any()):
            break
        force_edge_lists(
            arrays.vectors, arrays.neighbors,
            torch.where(active, a_s, -1), torch.where(active, t_s, -1),
            params,
        )
    arrays.dirty_rows[a_s[a_s >= 0].long()] = True
    # a_s is sorted: keep each adopter's first occurrence for the refresh.
    a_prev = torch.cat([torch.full_like(a_s[:1], -2), a_s[:-1]])
    return arrays, torch.where((a_s != a_prev) & (a_s >= 0), a_s, -1)


# --------------------------------------------------------------------- #
# Host-side maintenance planning (numpy), as in JAX core/builder.py
# (:1269-1378).


def plan_delete_repair(
    nbr_rows: np.ndarray,  # i32[Dn, R] each deleted node's out-edges
    del_slots: np.ndarray,  # i32[Dn]
    r: int,
):
    """Group the (target, deleted node) repair pairs of one delete batch:
    round k repairs each target against its k-th adjacent deleted node (in
    the order of ``del_slots``), so the round count is the largest
    adjacency multiplicity. Returns (rounds, rescue): rounds is a list of
    (targets i32[T], extra i32[T, R]); rescue is (affected nodes i32[U],
    ex-siblings i32[U, R]), or None when no live node was adjacent."""
    Dn = len(del_slots)
    tgt = nbr_rows.ravel()
    di = np.repeat(np.arange(Dn, dtype=np.int32), r)
    keep = (tgt >= 0) & ~np.isin(tgt, del_slots)
    tgt, di = tgt[keep], di[keep]
    rounds = []
    rescue = None
    if len(tgt):
        order = np.lexsort((di, tgt))
        tgt, di = tgt[order], di[order]
        first = np.concatenate([[True], tgt[1:] != tgt[:-1]])
        starts = np.maximum.accumulate(
            np.where(first, np.arange(len(tgt)), 0)
        )
        ranks = np.arange(len(tgt)) - starts
        for rr in range(int(ranks.max()) + 1):
            m = ranks == rr
            rounds.append(
                (tgt[m].astype(np.int32), nbr_rows[di[m]].astype(np.int32))
            )
        uniq, uidx = np.unique(tgt, return_index=True)
        rescue = (uniq.astype(np.int32), nbr_rows[di[uidx]].astype(np.int32))
    return rounds, rescue


def reachable_mask(
    nbrs_h: np.ndarray, valid_h: np.ndarray, entry: int
) -> np.ndarray:
    """Host BFS over live out-edges from the entry point."""
    reach = np.zeros(len(valid_h), bool)
    frontier = np.asarray([entry])
    reach[frontier] = True
    while len(frontier):
        nxt = nbrs_h[frontier].ravel()
        nxt = nxt[nxt >= 0]
        nxt = nxt[valid_h[nxt] & ~reach[nxt]]
        nxt = np.unique(nxt)
        reach[nxt] = True
        frontier = nxt
    return reach


def choose_adopters(
    orphans: np.ndarray,  # i32[n]
    tk: np.ndarray,  # i32[n, k] nearest reachable candidates per orphan
    nbrs_h: np.ndarray,  # [C, R]
    pad: int,
) -> np.ndarray:
    """Adopter of each orphan: its nearest reachable candidate, preferring
    one with a free neighbor slot (a force-link into a full row evicts its
    farthest edge, which can strand another node); adopters are distinct
    within a pass, falling back through the top-k on collision."""
    has_free = (nbrs_h < 0).any(axis=1)
    adopters = np.full(pad, -1, np.int32)
    seen: set[int] = set()
    for prefer_free in (True, False):
        for i in range(len(orphans)):
            if adopters[i] >= 0:
                continue
            for s in tk[i]:
                if (
                    s >= 0
                    and s != orphans[i]
                    and int(s) not in seen
                    and (not prefer_free or has_free[s])
                ):
                    adopters[i] = s
                    seen.add(int(s))
                    break
    return adopters


def select_fallback_entry(
    slot_to_rowid: dict, nbrs_h: np.ndarray, valid_h: np.ndarray
) -> tuple[int, int]:
    """Deterministic entry re-selection after the entry point dies: the
    live slot with the most live out-neighbors, ties to the smallest slot
    (the reference re-selects at random, GraphManager.cpp:564-621)."""
    if not slot_to_rowid:
        return -1, INVALID_ROW_ID
    live = np.asarray(sorted(slot_to_rowid), np.int32)
    nbrs = nbrs_h[live]
    degree = ((nbrs >= 0) & valid_h[np.maximum(nbrs, 0)]).sum(axis=1)
    slot = int(live[int(np.argmax(degree))])  # argmax ties -> smallest
    return slot, slot_to_rowid[slot]
