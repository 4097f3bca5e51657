"""Batched LM-DiskANN beam search as Python loops over device tensors.

Counterpart of ``duckdb_lm_diskann_tpu/core/searcher.py`` with the same
semantics (validated there against tests/oracle.py, exact visit order at
E = 1):

  * a (distance, slot)-sorted beam of L entries per query; each hop visits
    the E closest unvisited entries of every lane, logs their exact
    distances, and merges the visited nodes' E*R neighbors, scored from
    their cached edge codes, into the beam (insert-and-evict-worst,
    vectordiskann.c:1136-1148); at E > 1 two visited nodes may offer the
    same neighbor, and the merge keeps one copy;
  * neighbors already in the beam, or visited seeds, are skipped;
  * the loop ends when no lane has an unvisited beam entry, or once
    ``it * E`` reaches V (at most V visits per query);
  * top-k = the k best (exact distance, slot) pairs of the visited log,
    over the ``allowed`` slots only when a filter is given (traversal still
    routes through every node).

Entry points: ``beam_search`` (one lock-step batch), ``beam_search_many``
(NB batches one after another), ``beam_search_stream`` (lanes refilled from
a query queue as they converge) and ``pick_adaptive_seeds`` (per-query
seeds from a live sample).

A lane that has converged stays a no-op in later hops, so the host reads
the loop condition only every ``_CHECK_EVERY`` hops (each read waits for
the device); ``hops`` adds the device-side condition of every hop, so it
counts exactly the iterations of the JAX while-loops.

Each entry point takes ``rec``, the caller's ``utils.tracing.Recorder`` or
None, and records its ``search.*`` spans there (``utils/tracing.py`` names
them).

Frontier scoring of INT4, INT8 and TERNARY goes through the codec's kernel
module (``kernels.int4_frontier``, ``kernels.int8_frontier``,
``kernels.ternary_frontier``): the Hopper kernel for CUDA tensors, its plain
PyTorch version for CPU tensors. FLOAT32, FLOAT16, FLOAT1BIT and NONE have
no TPU kernel in the JAX package and are plain gathers here too. At E > 1
the kernels take B*E rows (the visited nodes flattened, each query
repeated E times). TERNARY scores are
integers mapped to distances by ``similarity_to_distance`` after the
kernel, as in the JAX package. The merge of every codec's candidates into
the beam is ``kernels.beam_merge`` (one kernel launch a hop on the card),
which writes the beam in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..common.types import EdgeType, MetricType
from ..kernels.beam_merge import beam_merge
from ..kernels.int4_frontier import int4_frontier_scores
from ..kernels.int8_frontier import int8_frontier_scores
from ..kernels.ternary_frontier import ternary_frontier_scores
from ..ops import topk as topk_ops
from ..ops.distance import pairwise_distance, similarity_to_distance
from ..ops.ternary import encode_ternary, popcount32
from .graph import GraphArrays, GraphParams

INF = float("inf")
_CHECK_EVERY = 4
# Slot key of an empty insert in the stream path's running top-k: sorts
# after every real slot at equal distance.
_NO_SLOT = 2**31 - 1
# Bytes of the [B, M, D] difference block of one pick_adaptive_seeds chunk.
_SEED_CHUNK_BYTES = 256 << 20


class SearchResult(NamedTuple):
    topk_slots: torch.Tensor  # i32[B, K]  (-1 padded)
    topk_dists: torch.Tensor  # f32[B, K]  (+inf padded)
    visited_slots: torch.Tensor  # i32[B, V] in visit order (-1 padded)
    visited_dists: torch.Tensor  # f32[B, V] exact distances (+inf padded)
    visited_count: torch.Tensor  # i32[B]
    hops: torch.Tensor  # i32[] loop iterations with an active lane


class ManySearchResult(NamedTuple):
    topk_slots: torch.Tensor  # i32[NB, B, K]
    topk_dists: torch.Tensor  # f32[NB, B, K]
    visited_count: torch.Tensor  # i32[NB, B]
    hops: torch.Tensor  # i32[NB]


class StreamSearchResult(NamedTuple):
    topk_slots: torch.Tensor  # i32[NQ, K] (-1 padded)
    topk_dists: torch.Tensor  # f32[NQ, K] (+inf padded)
    visited_count: torch.Tensor  # i32[NQ]
    hops: torch.Tensor  # i32[] loop iterations


def _frontier_scores(kernel, cur, query_args, tables, **kw):
    """``kernel(cur, *query_args, *tables)`` over whole tables. Over
    row-sharded tables (``parallel/global_graph.py``) the kernel runs on
    every row block's own tables for the whole batch, and each row keeps
    the output of the block that owns its node: every launch has the
    single-device batch shape."""
    map_rows = getattr(tables[0], "map_rows", None)
    if map_rows is None:
        return kernel(cur, *query_args, *tables, **kw)

    def on_block(local_cur, *blocks):
        dev = blocks[0].device
        return kernel(
            local_cur, *(q.to(dev) for q in query_args), *blocks, **kw
        )

    return map_rows(on_block, cur, *tables[1:])


def _score_edges(
    arrays: GraphArrays,
    params: GraphParams,
    cur: torch.Tensor,  # i32[N] current node slots
    queries: torch.Tensor,  # f32[N, D]
    q_planes: tuple[torch.Tensor, torch.Tensor] | None,  # sign-plane codecs
    nbrs: torch.Tensor,  # i32[N, R] the nodes' neighbor slots
) -> torch.Tensor:
    """Approximate distances [N, R] from the visited nodes' cached edge
    codes — no second gather for frontier scoring
    (vectordiskann.c:1370-1396). INT4, INT8 and TERNARY go through their
    kernels; the other codecs are plain gathers, as in the JAX package."""
    et = params.edge_type
    if et is EdgeType.INT4:
        return _frontier_scores(
            int4_frontier_scores, cur, (queries,),
            (arrays.edge_i4, arrays.edge_scale), metric=params.metric,
        )
    if et is EdgeType.INT8:
        return _frontier_scores(
            int8_frontier_scores, cur, (queries,),
            (arrays.edge_i8, arrays.edge_scale), metric=params.metric,
        )
    if et is EdgeType.TERNARY:
        sim = _frontier_scores(
            ternary_frontier_scores, cur, q_planes,
            (arrays.edge_pos, arrays.edge_neg),
        )
        return similarity_to_distance(sim.float(), params.metric)
    if et is EdgeType.FLOAT32 or et is EdgeType.FLOAT16:
        vecs = arrays.edge_f32.index_select(0, cur).float()  # [N, R, D]
        return pairwise_distance(queries[:, None, :], vecs, params.metric)
    if et is EdgeType.FLOAT1BIT:
        # Binarized signed dot: with sign bits (bit = v > 0) the dot over
        # +/-1 values is D - 2 * pop(q XOR e). Padding bits are zero in
        # both planes, so whole words XOR exactly. Cosine only.
        e_pos = arrays.edge_pos.index_select(0, cur)  # [N, R, W]
        mismatch = popcount32(q_planes[0][:, None, :] ^ e_pos).sum(-1)
        sim = (params.dims - 2 * mismatch).float()
        return similarity_to_distance(sim, params.metric)
    # EdgeType.NONE: exact traversal over the neighbors' own vectors (the
    # C++ Searcher, core/Searcher.cpp:168-173).
    vecs = arrays.vectors[nbrs.clamp_min(0).long()].float()  # [N, R, D]
    return pairwise_distance(queries[:, None, :], vecs, params.metric)


def _query_planes(params: GraphParams, queries: torch.Tensor):
    """Query sign planes (TERNARY, FLOAT1BIT), encoded once per search,
    not once per hop."""
    if params.edge_type in (EdgeType.TERNARY, EdgeType.FLOAT1BIT):
        return encode_ternary(queries)
    return None


def _seed_prefix(arrays, queries, seeds, metric, assume_all_valid):
    """Each query's seed set with exact distances, (dist, slot)-sorted with
    duplicates collapsed (vectordiskann.c:1306-1322). ``seeds`` is i32[S]
    (shared) or i32[B, S] (per query). Returns (seeds_b i32[B, S],
    dist f32[B, S], slots i32[B, S])."""
    B = queries.shape[0]
    if seeds.dim() == 2:
        seeds_b = seeds.contiguous()
        seed_vec = arrays.vectors[seeds_b.clamp_min(0).long()].float()
    else:
        # Materialised once a search: the merge kernel reads rows of it.
        seeds_b = seeds[None, :].expand(B, seeds.shape[0]).contiguous()
        seed_vec = arrays.vectors.index_select(0, seeds.clamp_min(0)).float()
        seed_vec = seed_vec[None]
    seed_dist = pairwise_distance(queries[:, None, :], seed_vec, metric)
    seed_ok = seeds_b >= 0
    if not assume_all_valid:
        seed_ok = seed_ok & arrays.valid[seeds_b.clamp_min(0).long()]
    sd, ss = topk_ops.mask_invalid(seed_dist, seeds_b, seed_ok)
    sd, ss = topk_ops.sort_by_distance_id(sd, ss)
    if seeds_b.shape[1] > 1:  # duplicate seeds collapse to one beam entry
        sd, ss = topk_ops.dedup_sorted_ids(sd, ss)
        sd, ss = topk_ops.sort_by_distance_id(sd, ss)
    return seeds_b, sd, ss


def _pad_beam(sd, ss, L):
    B, S = sd.shape
    dev = sd.device
    return (
        torch.cat([sd, torch.full((B, L - S), INF, device=dev)], -1),
        torch.cat(
            [ss, torch.full((B, L - S), -1, dtype=torch.int32, device=dev)],
            -1,
        ),
    )


def _check(flag: torch.Tensor, rec) -> bool:
    """``bool(flag)``: the host's blocking read of the loop condition."""
    if rec is None:
        return bool(flag)
    rec.open("search.check")
    go = bool(flag)
    rec.close()
    return go


def _hop(
    arrays, params, queries, q_planes, beam_dist, beam_slot, beam_vis,
    seeds_b, seed_vis, E, assume_all_valid, rec=None,
):
    """One hop of every lane: visit the E closest unvisited beam entries,
    take their exact distances, score their neighbors' cached codes and
    merge the new candidates into the beam. The beam (``beam_dist``,
    ``beam_slot``, ``beam_vis``) and ``seed_vis`` are updated in place.
    Returns (beam_dist, beam_slot, beam_vis, cur
    i32[B, E], active bool[B, E], exact f32[B, E])."""
    if rec is not None:
        rec.open("search.hop.visit")
    B, L = beam_slot.shape
    unvis = ~beam_vis & (beam_slot >= 0)  # [B, L]
    # The beam is sorted: the first unvisited entries are the closest
    # (diskAnnSearchCtxFindClosestCandidateIdx, vectordiskann.c:1152-1167).
    if E == 1:
        idx_e = unvis.to(torch.uint8).argmax(-1, keepdim=True)  # [B, 1]
    else:
        # The E smallest unvisited positions; a stable sort breaks ties by
        # the lowest index, as lax.top_k does in the JAX package.
        pos = torch.arange(L, device=unvis.device)
        pos_key = torch.where(unvis, pos, L)
        idx_e = torch.sort(pos_key, dim=-1, stable=True).indices[:, :E]
    active = unvis.gather(1, idx_e)  # [B, E]
    cur = torch.where(active, beam_slot.gather(1, idx_e), 0)  # i32[B, E]
    cur_f = cur.reshape(-1)  # [B*E]: the kernels' row layout
    q_f, p_f = queries, q_planes
    if E > 1:  # each query repeated once per visited node
        q_f = queries.repeat_interleave(E, 0)
        if q_planes is not None:
            p_f = tuple(p.repeat_interleave(E, 0) for p in q_planes)

    # Visit: exact distance to the full-precision vector (:1366-1370).
    node_vec = arrays.vectors.index_select(0, cur_f).float()
    exact = pairwise_distance(q_f, node_vec, params.metric).reshape(B, E)
    beam_vis.scatter_(1, idx_e, beam_vis.gather(1, idx_e) | active)
    seed_vis |= (
        (cur[:, :, None] == seeds_b[:, None, :]) & active[:, :, None]
    ).any(1)

    # Frontier: the nodes' R neighbor slots and their cached codes.
    if rec is not None:
        rec.switch("search.hop.score")
    R = params.r
    nbrs = arrays.neighbors.index_select(0, cur_f)  # [B*E, R]
    live = nbrs >= 0
    if not assume_all_valid:
        live = live & arrays.valid[nbrs.clamp_min(0).long()]
    live = live & active.reshape(-1, 1)
    edge_dist = _score_edges(arrays, params, cur_f, q_f, p_f, nbrs)

    # Merge the candidates not already in the beam or among the visited
    # seeds into the beam, in place (kernels/beam_merge.py).
    if rec is not None:
        rec.switch("search.hop.merge")
    beam_merge(
        beam_dist, beam_slot, beam_vis, nbrs.reshape(B, E, R),
        edge_dist.reshape(B, E, R), live.reshape(B, E, R), seeds_b, seed_vis,
    )
    if rec is not None:
        rec.close()
    return beam_dist, beam_slot, beam_vis, cur, active, exact


def _as_seeds(entry_slot, dev):
    seeds = torch.as_tensor(entry_slot, dtype=torch.int32, device=dev)
    return seeds.reshape(-1) if seeds.dim() == 0 else seeds  # scalar -> [1]


def beam_search(
    arrays: GraphArrays,
    queries: torch.Tensor,  # f32[B, D]
    entry_slot,  # int | i32[] | i32[S] shared seeds | i32[B, S] per query
    *,
    params: GraphParams,
    l_search: int,
    k: int,
    max_visits: int = 0,
    beam_width: int = 1,
    allowed: torch.Tensor | None = None,  # bool[capacity] result filter
    assume_all_valid: bool = False,
    rec=None,
) -> SearchResult:
    """Batched beam search. Returns the top-k and the visited log (the
    insert path consumes the visited set).

    ``allowed`` restricts the final top-k to visited AND allowed slots; the
    walk still routes through every node (filtered-DiskANN).

    ``assume_all_valid``: the caller asserts every edge target is live (no
    slot was ever tombstoned), which skips the neighbor-validity gather;
    results are identical when it holds."""
    dev = arrays.device
    queries = queries.to(device=dev, dtype=torch.float32)
    B = queries.shape[0]
    L = l_search
    E = beam_width
    if E < 1:
        raise ValueError(f"beam_width must be >= 1, got {E}")
    V = max_visits if max_visits > 0 else params.max_visits
    seeds = _as_seeds(entry_slot, dev)
    if seeds.shape[-1] > L:
        raise ValueError("seed count exceeds l_search")
    if rec is not None:
        rec.open("search.seed")
    q_planes = _query_planes(params, queries)
    seeds_b, sd, ss = _seed_prefix(
        arrays, queries, seeds, params.metric, assume_all_valid
    )
    beam_dist, beam_slot = _pad_beam(sd, ss, L)
    beam_vis = torch.zeros((B, L), dtype=torch.bool, device=dev)
    seed_vis = torch.zeros(seeds_b.shape, dtype=torch.bool, device=dev)
    # Visited log with one scratch column (index V): inactive lanes, and
    # visits past V at E > 1, write there (JAX drops them; vis_cnt still
    # counts them).
    vis_slot = torch.full((B, V + 1), -1, dtype=torch.int32, device=dev)
    vis_dist = torch.full((B, V + 1), INF, device=dev)
    vis_cnt = torch.zeros((B,), dtype=torch.int32, device=dev)
    hops = torch.zeros((), dtype=torch.int32, device=dev)
    if rec is not None:
        rec.close()

    for it in range(-(-V // E)):  # while it * E < V
        any_unvis = (~beam_vis & (beam_slot >= 0)).any()
        if it % _CHECK_EVERY == 0 and not _check(any_unvis, rec):
            break
        if rec is not None:
            rec.open("search.hop")
        hops += any_unvis.to(torch.int32)
        beam_dist, beam_slot, beam_vis, cur, active, exact = _hop(
            arrays, params, queries, q_planes, beam_dist, beam_slot,
            beam_vis, seeds_b, seed_vis, E, assume_all_valid, rec,
        )
        if rec is not None:
            rec.open("search.hop.log")
        # Append the visits at disjoint positions vis_cnt, vis_cnt+1, ...
        order = active.to(torch.int32).cumsum(-1) - 1
        pos = torch.where(active, vis_cnt[:, None] + order, V)
        pos = pos.clamp_max(V).long()
        vis_slot.scatter_(1, pos, cur)
        vis_dist.scatter_(1, pos, exact)
        vis_cnt += active.sum(-1, dtype=torch.int32)
        if rec is not None:
            rec.close()  # search.hop.log
            rec.close()  # search.hop

    if rec is not None:
        rec.open("search.rerank")
    # Final pass: top-k = the k best (exact dist, slot) among visited nodes,
    # deduplicated (vectordiskann.c:1091-1110).
    vis_slot, vis_dist = vis_slot[:, :V], vis_dist[:, :V]
    rank_dist = vis_dist
    if allowed is not None:
        ok = allowed[vis_slot.clamp_min(0).long()] & (vis_slot >= 0)
        rank_dist = torch.where(ok, vis_dist, INF)
    sd, ss = topk_ops.sorted_dedup_topk(rank_dist, vis_slot)
    topk_dists, topk_slots = sd[:, :k], ss[:, :k]
    topk_slots = torch.where(
        torch.isinf(topk_dists), torch.full_like(topk_slots, -1), topk_slots
    )
    if rec is not None:
        rec.close()
    return SearchResult(
        topk_slots=topk_slots,
        topk_dists=topk_dists,
        visited_slots=vis_slot,
        visited_dists=vis_dist,
        visited_count=vis_cnt,
        hops=hops,
    )


def beam_search_many(
    arrays: GraphArrays,
    queries: torch.Tensor,  # f32[NB, B, D]: NB batches of B queries
    entry_slot,  # shared seeds as in beam_search, or i32[NB, B, S]
    *,
    params: GraphParams,
    l_search: int,
    k: int,
    max_visits: int = 0,
    beam_width: int = 1,
    allowed: torch.Tensor | None = None,
    assume_all_valid: bool = False,
    rec=None,
) -> ManySearchResult:
    """NB lock-step batches searched one after another: the JAX package's
    ``lax.scan`` of beam_search as a plain loop. Results are identical to
    NB ``beam_search`` calls; the per-batch visited logs are dropped."""
    ent = _as_seeds(entry_slot, arrays.device)
    outs = []
    for nb in range(queries.shape[0]):
        res = beam_search(
            arrays,
            queries[nb],
            ent[nb] if ent.dim() == 3 else ent,
            params=params,
            l_search=l_search,
            k=k,
            max_visits=max_visits,
            beam_width=beam_width,
            allowed=allowed,
            assume_all_valid=assume_all_valid,
            rec=rec,
        )
        outs.append(
            (res.topk_slots, res.topk_dists, res.visited_count, res.hops)
        )
    return ManySearchResult(*(torch.stack(x) for x in zip(*outs)))


def beam_search_stream(
    arrays: GraphArrays,
    queries: torch.Tensor,  # f32[NQ, D]
    entry_slot,  # int | i32[] | i32[S] | i32[NQ, S]
    *,
    params: GraphParams,
    l_search: int,
    k: int,
    lanes: int = 1024,
    max_visits: int = 0,
    allowed: torch.Tensor | None = None,
    assume_all_valid: bool = False,
    rec=None,
) -> StreamSearchResult:
    """Streaming beam search with continuous lane refill (E = 1): the
    moment a lane's beam has no unvisited entry, the lane writes its result
    and takes the next query of the queue, so the total hop count follows
    the total visits over ``lanes`` rather than the sum of the lock-step
    batches' slowest queries.

    Per-query results equal :func:`beam_search`'s: the same seeding and hop,
    and the exact re-rank over the visited set kept as a running top-k
    (each visit's (exact, slot) shift-inserted into a sorted [B, K] buffer;
    a membership guard stands in for the visited-log dedup). Like the JAX
    package's stream path, no query is capped at V visits: the loop ends
    when the queue is empty and every lane has converged (or after the
    generous ``max_iters`` cap)."""
    dev = arrays.device
    queries = queries.to(device=dev, dtype=torch.float32)
    NQ, D = queries.shape
    B = min(lanes, NQ)
    L = l_search
    K = k
    V = max_visits if max_visits > 0 else params.max_visits
    seeds = _as_seeds(entry_slot, dev)
    if seeds.shape[-1] > L:
        raise ValueError("seed count exceeds l_search")
    if rec is not None:
        rec.open("search.seed")
    q_planes_all = _query_planes(params, queries)
    # Every query's seeded beam prefix, in one pass.
    _, sd_all, ss_all = _seed_prefix(
        arrays, queries, seeds, params.metric, assume_all_valid
    )
    beam0_dist, beam0_slot = _pad_beam(sd_all, ss_all, L)  # [NQ, L]
    S = ss_all.shape[1]

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    i32, b8 = torch.int32, torch.bool
    beam_dist, beam_slot = full((B, L), INF), full((B, L), -1, i32)
    beam_vis = full((B, L), False, b8)
    seed_slots, seed_vis = full((B, S), -1, i32), full((B, S), False, b8)
    top_dist, top_slot = full((B, K), INF), full((B, K), -1, i32)
    q_lane = torch.zeros((B, D), device=dev)
    p_lane = (
        None if q_planes_all is None
        else tuple(torch.zeros((B, p.shape[1]), dtype=p.dtype, device=dev)
                   for p in q_planes_all)
    )
    lane_q = full((B,), -1, i32)
    vis_cnt = full((B,), 0, i32)
    next_q = torch.zeros((), dtype=i32, device=dev)
    # Result rows, plus a scratch row NQ for lanes that finish nothing.
    out_slot, out_dist = full((NQ + 1, K), -1, i32), full((NQ + 1, K), INF)
    out_vis = full((NQ + 1,), 0, i32)
    hops = torch.zeros((), dtype=i32, device=dev)
    pos_k = torch.arange(K, device=dev)
    # Generous cap: perfect packing needs ~NQ*V/B iterations; the slack
    # covers ragged refill tails (the JAX package's bound).
    max_iters = (NQ * V) // B + 2 * V + 8
    if rec is not None:
        rec.close()

    for it in range(max_iters):
        go = (next_q < NQ) | (lane_q >= 0).any()
        if it % _CHECK_EVERY == 0 and not _check(go, rec):
            break
        # Once `go` is false every lane is dead and the queue is empty, so
        # the body below changes nothing: it stays false.
        if rec is not None:
            rec.open("search.hop")
        hops += go.to(i32)
        needs = ~(~beam_vis & (beam_slot >= 0)).any(-1)  # converged or idle

        # Finalize: converged live lanes write their running top-k.
        fin = needs & (lane_q >= 0)
        w = torch.where(fin, lane_q, NQ).long()
        out_slot[w] = top_slot
        out_dist[w] = top_dist
        out_vis[w] = vis_cnt

        # Refill: converged lanes take the next queue entries.
        rank = needs.to(i32).cumsum(0) - 1
        cand_q = next_q + rank
        assign = needs & (cand_q < NQ)
        new_q = torch.where(assign, cand_q, 0)
        nq_l = new_q.long()
        a1 = assign[:, None]
        q_lane = torch.where(a1, queries[nq_l], q_lane)
        if p_lane is not None:
            p_lane = tuple(
                torch.where(a1, p[nq_l], pl) for p, pl in zip(q_planes_all, p_lane)
            )
        seed_slots = torch.where(a1, ss_all[nq_l], seed_slots)
        seed_vis = seed_vis & ~a1
        beam_dist = torch.where(a1, beam0_dist[nq_l], beam_dist)
        beam_slot = torch.where(a1, beam0_slot[nq_l], beam_slot)
        beam_vis = beam_vis & ~a1
        top_dist = torch.where(a1, INF, top_dist)
        top_slot = torch.where(a1, -1, top_slot)
        vis_cnt = torch.where(assign, 0, vis_cnt)
        lane_q = torch.where(assign, new_q, torch.where(needs, -1, lane_q))
        n_taken = torch.minimum(needs.sum(dtype=i32), NQ - next_q)
        next_q = next_q + n_taken.clamp_min(0)

        # Hop: beam_search's E=1 hop over the live lanes (refilled lanes
        # make their first visit in this same iteration).
        beam_dist, beam_slot, beam_vis, cur, active, exact = _hop(
            arrays, params, q_lane, p_lane, beam_dist, beam_slot, beam_vis,
            seed_slots, seed_vis, 1, assume_all_valid, rec,
        )
        vis_cnt = vis_cnt + active[:, 0].to(i32)

        # Running top-k: shift-insert the visit's (exact, slot) pair.
        d_new, s_new, ins_ok = exact[:, 0], cur[:, 0], active[:, 0]
        if allowed is not None:
            ins_ok = ins_ok & allowed[s_new.clamp_min(0).long()]
        ins_ok = ins_ok & ~(top_slot == s_new[:, None]).any(-1)
        d_new = torch.where(ins_ok, d_new, INF)[:, None]
        s_new = torch.where(ins_ok, s_new, _NO_SLOT)[:, None]
        better = (top_dist < d_new) | ((top_dist == d_new) & (top_slot < s_new))
        pos = better.sum(-1, keepdim=True)
        shift_d = torch.cat([top_dist[:, :1], top_dist[:, :-1]], -1)
        shift_s = torch.cat([top_slot[:, :1], top_slot[:, :-1]], -1)
        keep, here = pos_k < pos, pos_k == pos
        top_dist = torch.where(keep, top_dist, torch.where(here, d_new, shift_d))
        top_slot = torch.where(keep, top_slot, torch.where(here, s_new, shift_s))
        top_slot = torch.where(torch.isinf(top_dist), -1, top_slot)
        if rec is not None:
            rec.close()

    return StreamSearchResult(
        topk_slots=out_slot[:NQ],
        topk_dists=out_dist[:NQ],
        visited_count=out_vis[:NQ],
        hops=hops,
    )


def pick_adaptive_seeds(
    vectors: torch.Tensor,  # [C, D] node vectors (storage dtype)
    queries: torch.Tensor,  # f32[B, D]
    sample_slots: torch.Tensor,  # i32[M] live sample slots
    *,
    metric: MetricType,
    s_count: int,
) -> torch.Tensor:
    """Query-adaptive seeds: each query's ``s_count`` nearest nodes among a
    live sample, i32[B, S], for beam_search / beam_search_many /
    beam_search_stream. The [B, M] distances take the direct-difference
    form of ``pairwise_distance`` in query chunks (bounded memory); the
    top-S is a stable sort, so equal distances go to the lowest sample
    index first, as lax.top_k orders them."""
    queries = queries.to(device=vectors.device, dtype=torch.float32)
    sv = vectors.index_select(0, sample_slots.long()).float()  # [M, D]
    M, D = sv.shape
    step = max(1, _SEED_CHUNK_BYTES // max(4 * M * D, 1))
    picks = []
    for q in queries.split(step):
        d = pairwise_distance(q[:, None, :], sv[None, :, :], metric)
        idx = torch.sort(d, dim=-1, stable=True).indices[:, :s_count]
        picks.append(sample_slots[idx])
    if not picks:
        return torch.zeros((0, s_count), dtype=torch.int32, device=vectors.device)
    return torch.cat(picks).to(torch.int32)


def search_for_initial_candidates(
    arrays: GraphArrays,
    queries: torch.Tensor,
    entry_slot,
    *,
    params: GraphParams,
    l_insert: int,
    beam_width: int = 1,
    assume_all_valid: bool = False,
    rec=None,
) -> SearchResult:
    """Insert-path candidate search: beam search with L = k = L_insert
    (Searcher::SearchForInitialCandidates, core/Searcher.cpp:275-294) and a
    visit budget of insert_max_visits (2 * L_insert by default).
    ``beam_width`` > 1 (batched builds, params.insert_beam_width) visits
    that many nodes a hop; sequential inserts keep width 1."""
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
        rec=rec,
    )
