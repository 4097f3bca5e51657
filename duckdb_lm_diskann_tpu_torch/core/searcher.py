"""Batched LM-DiskANN beam search (E=1) as a Python loop over device tensors.

Counterpart of ``duckdb_lm_diskann_tpu/core/searcher.py::beam_search`` at
beam width 1, with the same semantics (validated there against
tests/oracle.py, exact visit order):

  * a (distance, slot)-sorted beam of L entries per query; each hop visits
    the closest unvisited entry of every lane, logs its exact distance, and
    merges the visited node's R neighbors, scored from their cached edge
    codes, into the beam (insert-and-evict-worst, vectordiskann.c:1136-1148);
  * neighbors already in the beam, or visited seeds, are skipped;
  * the loop ends when no lane has an unvisited beam entry, or after V hops
    (the ``it * E < V`` cap with E = 1);
  * top-k = the k best (exact distance, slot) pairs of the visited log.

A lane that has converged stays a no-op in later hops, so the host reads
the "any lane unvisited" flag only every ``_CHECK_EVERY`` hops (each read
waits for the device); ``hops`` still counts exactly the hops in which some
lane was active, as the JAX while-loop does.

Frontier scoring goes through ``kernels.int4_frontier``: the Hopper kernel
for CUDA tensors, its plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from duckdb_lm_diskann_tpu.common.types import EdgeType

from ..kernels.int4_frontier import int4_frontier_scores
from ..ops import topk as topk_ops
from ..ops.distance import pairwise_distance
from .graph import GraphArrays, GraphParams

INF = float("inf")
_CHECK_EVERY = 4


class SearchResult(NamedTuple):
    topk_slots: torch.Tensor  # i32[B, K]  (-1 padded)
    topk_dists: torch.Tensor  # f32[B, K]  (+inf padded)
    visited_slots: torch.Tensor  # i32[B, V] in visit order (-1 padded)
    visited_dists: torch.Tensor  # f32[B, V] exact distances (+inf padded)
    visited_count: torch.Tensor  # i32[B]
    hops: torch.Tensor  # i32[] loop iterations with an active lane


def _score_edges(
    arrays: GraphArrays,
    params: GraphParams,
    cur: torch.Tensor,  # i32[B] current node slots
    queries: torch.Tensor,  # f32[B, D]
) -> torch.Tensor:
    """Approximate distances [B, R] from the visited nodes' cached edge
    codes — no second gather for frontier scoring
    (vectordiskann.c:1370-1396)."""
    if params.edge_type is EdgeType.INT4:
        return int4_frontier_scores(
            cur, queries, arrays.edge_i4, arrays.edge_scale,
            metric=params.metric,
        )
    raise NotImplementedError(
        f"edge type {params.edge_type.value} is not ported yet "
        "(ROADMAP queue 1, item 8: the other codecs)"
    )


def beam_search(
    arrays: GraphArrays,
    queries: torch.Tensor,  # f32[B, D]
    entry_slot,  # int | i32[] | i32[S] shared seed set
    *,
    params: GraphParams,
    l_search: int,
    k: int,
    max_visits: int = 0,
    beam_width: int = 1,
    assume_all_valid: bool = False,
) -> SearchResult:
    """Batched beam search. Returns the top-k and the visited log (the
    insert path consumes the visited set).

    ``assume_all_valid``: the caller asserts every edge target is live (no
    slot was ever tombstoned), which skips the neighbor-validity gather;
    results are identical when it holds."""
    if beam_width != 1:
        raise NotImplementedError(
            "beam_width > 1 is not ported yet (ROADMAP queue 1, item 7)"
        )
    dev = arrays.device
    queries = queries.to(device=dev, dtype=torch.float32)
    B = queries.shape[0]
    L = l_search
    V = max_visits if max_visits > 0 else params.max_visits
    metric = params.metric
    seeds = torch.as_tensor(entry_slot, dtype=torch.int32, device=dev)
    seeds = seeds.reshape(-1)  # scalar -> [1]
    S = seeds.shape[0]
    if S > L:
        raise ValueError("seed count exceeds l_search")

    # --- Seed the beam with the exact distances of the entry point(s)
    # (vectordiskann.c:1306-1322).
    seeds_b = seeds[None, :].expand(B, S)
    seed_vec = arrays.vectors.index_select(0, seeds.clamp_min(0)).float()
    seed_dist = pairwise_distance(queries[:, None, :], seed_vec[None], metric)
    seed_ok = seeds_b >= 0
    if not assume_all_valid:
        seed_ok = seed_ok & arrays.valid[seeds_b.clamp_min(0).long()]
    sd, ss = topk_ops.mask_invalid(seed_dist, seeds_b, seed_ok)
    sd, ss = topk_ops.sort_by_distance_id(sd, ss)
    if S > 1:  # duplicate seeds collapse to one beam entry
        sd, ss = topk_ops.dedup_sorted_ids(sd, ss)
        sd, ss = topk_ops.sort_by_distance_id(sd, ss)
    beam_dist = torch.cat([sd, torch.full((B, L - S), INF, device=dev)], -1)
    beam_slot = torch.cat(
        [ss, torch.full((B, L - S), -1, dtype=torch.int32, device=dev)], -1
    )
    beam_vis = torch.zeros((B, L), dtype=torch.bool, device=dev)
    seed_vis = torch.zeros((B, S), dtype=torch.bool, device=dev)
    # Visited log with one scratch column (index V) for inactive lanes.
    vis_slot = torch.full((B, V + 1), -1, dtype=torch.int32, device=dev)
    vis_dist = torch.full((B, V + 1), INF, device=dev)
    vis_cnt = torch.zeros((B,), dtype=torch.int32, device=dev)
    hops = torch.zeros((), dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    no_cand = torch.zeros((B, params.r), dtype=torch.bool, device=dev)

    for it in range(V):  # the `it * E < V` cap, E = 1
        unvis = ~beam_vis & (beam_slot >= 0)  # [B, L]
        any_unvis = unvis.any()
        if it % _CHECK_EVERY == 0 and not bool(any_unvis):
            break
        hops += any_unvis.to(torch.int32)
        # The beam is sorted: the first unvisited entry is the closest
        # (diskAnnSearchCtxFindClosestCandidateIdx, vectordiskann.c:1152-1167).
        idx = unvis.to(torch.uint8).argmax(-1)  # [B]
        active = unvis[rows, idx]
        cur = torch.where(active, beam_slot[rows, idx], 0)  # i32[B]

        # Visit: exact distance to the full-precision vector (:1366-1370).
        node_vec = arrays.vectors.index_select(0, cur).float()
        exact = pairwise_distance(queries, node_vec, metric)  # [B]
        beam_vis[rows, idx] = beam_vis[rows, idx] | active
        seed_vis |= (cur[:, None] == seeds_b) & active[:, None]
        pos = torch.where(active, vis_cnt, V).long()
        vis_slot[rows, pos] = cur
        vis_dist[rows, pos] = exact
        vis_cnt += active.to(torch.int32)

        # Frontier: the node's R neighbor slots and their cached codes.
        nbrs = arrays.neighbors.index_select(0, cur)  # [B, R]
        live = nbrs >= 0
        if not assume_all_valid:
            live = live & arrays.valid[nbrs.clamp_min(0).long()]
        live = live & active[:, None]
        edge_dist = _score_edges(arrays, params, cur, queries)  # [B, R]

        # Skip neighbors already in the beam or already-visited seeds (see
        # the JAX searcher for why this replaces the visited-list scan).
        in_beam = (
            (nbrs[:, :, None] == beam_slot[:, None, :])
            & (beam_slot >= 0)[:, None, :]
        ).any(-1)
        in_vis_seed = (
            (nbrs[:, :, None] == seeds_b[:, None, :]) & seed_vis[:, None, :]
        ).any(-1)
        cand_ok = live & ~in_beam & ~in_vis_seed
        cand_dist, cand_slot = topk_ops.mask_invalid(edge_dist, nbrs, cand_ok)

        beam_dist, beam_slot, beam_vis = topk_ops.merge_beams(
            beam_dist, beam_slot, cand_dist, cand_slot, L,
            extras_a=(beam_vis,), extras_b=(no_cand,),
        )
        # Entries that sorted to +inf are empty; normalize their slot to -1.
        beam_slot = torch.where(
            torch.isinf(beam_dist), torch.full_like(beam_slot, -1), beam_slot
        )

    # Final pass: top-k = the k best (exact dist, slot) among visited nodes,
    # deduplicated (vectordiskann.c:1091-1110).
    vis_slot, vis_dist = vis_slot[:, :V], vis_dist[:, :V]
    sd, ss = topk_ops.sorted_dedup_topk(vis_dist, vis_slot)
    topk_dists, topk_slots = sd[:, :k], ss[:, :k]
    topk_slots = torch.where(
        torch.isinf(topk_dists), torch.full_like(topk_slots, -1), topk_slots
    )
    return SearchResult(
        topk_slots=topk_slots,
        topk_dists=topk_dists,
        visited_slots=vis_slot,
        visited_dists=vis_dist,
        visited_count=vis_cnt,
        hops=hops,
    )


def search_for_initial_candidates(
    arrays: GraphArrays,
    queries: torch.Tensor,
    entry_slot,
    *,
    params: GraphParams,
    l_insert: int,
    beam_width: int = 1,
    assume_all_valid: bool = False,
) -> SearchResult:
    """Insert-path candidate search: beam search with L = k = L_insert
    (Searcher::SearchForInitialCandidates, core/Searcher.cpp:275-294) and a
    visit budget of insert_max_visits (2 * L_insert by default)."""
    return beam_search(
        arrays,
        queries,
        entry_slot,
        params=params,
        l_search=l_insert,
        k=l_insert,
        max_visits=(
            params.insert_max_visits
            if params.insert_max_visits > 0
            else 2 * l_insert
        ),
        beam_width=beam_width,
        assume_all_valid=assume_all_valid,
    )
