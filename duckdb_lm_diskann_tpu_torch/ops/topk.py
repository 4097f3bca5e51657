"""Deterministic (distance, id) sorts, dedup and sorted-beam merges.

Counterpart of ``duckdb_lm_diskann_tpu/ops/topk.py``. Every sort is
lexicographic ascending on (distance, id) and stable, built from stable
``torch.sort`` passes: by id first, then by distance. Equal distances
resolve to the smaller id on every device and batch size. -0.0 and +0.0
compare equal, as in the NumPy oracle's tuple sort (``tests/oracle.py``).

The JAX package's bitonic networks are a TPU/XLA-CPU speed device and are
not ported: here one sort serves every caller.
"""

from __future__ import annotations

import torch

INF = float("inf")


def lex_sort(keys, extras=()):
    """Stable lexicographic sort along the last axis by ``keys`` (primary
    key first); ``extras`` are permuted along. Returns sorted keys + extras."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key.gather(-1, perm)
        _, p = torch.sort(k, dim=-1, stable=True)
        perm = p if perm is None else perm.gather(-1, p)
    return tuple(a.gather(-1, perm) for a in tuple(keys) + tuple(extras))


def sort_by_distance_id(dist, ids, *extras):
    """Sort along the last axis by (dist, id) ascending; extras ride along.
    Invalid entries should carry dist=+inf."""
    return lex_sort((dist, ids), extras)


def topk_by_distance(dist, ids, k):
    """The k smallest (dist, id) pairs along the last axis, in that order
    (a -0.0 and a +0.0 tie and resolve by id)."""
    sorted_dist, sorted_ids = sort_by_distance_id(dist, ids)
    return sorted_dist[..., :k], sorted_ids[..., :k]


def mask_invalid(dist, ids, valid):
    """Push invalid entries to (+inf, -1) so sorts move them to the tail."""
    return (
        torch.where(valid, dist, torch.full_like(dist, INF)),
        torch.where(valid, ids, torch.full_like(ids, -1)),
    )


def _dup_of_prev(ids):
    prev = torch.cat([torch.full_like(ids[..., :1], -2), ids[..., :-1]], -1)
    return (ids == prev) & (ids >= 0)


def dedup_sorted_ids(dist, ids):
    """After a (dist, id) sort, mask duplicate ids (keep first occurrence).
    A duplicated id carries an identical distance, so copies are adjacent."""
    return mask_invalid(dist, ids, ~_dup_of_prev(ids))


def sorted_dedup_topk(dist, ids):
    """Sort by (dist, id), mask duplicate ids, re-sort (the exact re-rank of
    the visited log). Callers truncate to k."""
    sd, ss = sort_by_distance_id(dist, ids)
    sd, ss = dedup_sorted_ids(sd, ss)
    return sort_by_distance_id(sd, ss)


def merge_beams(
    dist_a, ids_a, dist_b, ids_b, size, *, extras_a=(), extras_b=(),
    dedup=False,
):
    """Merge two (dist, id, extras...) candidate sets and keep the best
    ``size`` — insert-and-evict-worst for a whole batch of candidates
    (vectordiskann.c:1136-1148). Callers pre-mask unwanted entries to +inf.

    ``dedup``: drop duplicate ids first, keeping each id's best (distance,
    then original order) copy: one sort by (id, distance) makes all copies
    adjacent, then a sort by (distance, id). Without it (the E=1 hop, whose
    beam and candidates share no ids) the merge is one (distance, id) sort.
    """
    dist = torch.cat([dist_a, dist_b], -1)
    ids = torch.cat([ids_a, ids_b], -1)
    extras = tuple(
        torch.cat([ea, eb], -1)
        for ea, eb in zip(extras_a, extras_b, strict=True)
    )
    if dedup:
        ids_s, dist_s, *ext = lex_sort((ids, dist), extras)
        dist_s, ids_s = mask_invalid(dist_s, ids_s, ~_dup_of_prev(ids_s))
        out = sort_by_distance_id(dist_s, ids_s, *ext)
    else:
        out = sort_by_distance_id(dist, ids, *extras)
    return tuple(o[..., :size] for o in out)
