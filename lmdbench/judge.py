"""Deciding ``correct``: the program's answers against the plain reference.

An answer is one query's k (row id, distance) pairs as the timed path
returned them. The numbers compared, each against the limit its
configuration's ``correct`` block sets:

    missing       answers with an id outside the live rows, a repeated id
                  or a distance that is not finite
    dist_rel_err  the widest gap between a returned distance and the f64
                  distance of the returned row, over max(f64 distance,
                  1e-4) (the guarantee: every returned distance is exact)
    recall_at_10  over the pool's answers, the share of the reference's
                  exact top-k found; a returned row as near as the
                  reference's k-th counts (ties), at most k per answer
    unread        acknowledged inserts whose own vector, searched, does
                  not return their id (the guarantee: every acknowledged
                  insert is searchable)

``recall_at_10`` is also the cells' end-to-end quality metric.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import reference

DIST_FLOOR = 1e-4


@dataclasses.dataclass
class Answers:
    """Answers to ``queries[q_idx[i]]``: ids i64[M, k], dists [M, k].
    ``own`` (read-back answers): the row id each query's vector belongs
    to."""

    queries: np.ndarray
    q_idx: np.ndarray
    ids: np.ndarray
    dists: np.ndarray
    own: np.ndarray | None = None

    @staticmethod
    def join(queries, parts, k) -> "Answers":
        if not parts:
            return Answers(queries, np.zeros(0, np.int64),
                           np.zeros((0, k), np.int64), np.zeros((0, k)))
        q, i, d = zip(*parts)
        return Answers(queries, np.concatenate(q), np.concatenate(i),
                       np.concatenate(d))


def _valid(ans: Answers, n_live: int) -> np.ndarray:
    ids = ans.ids
    ok = (ids >= 0).all(1) & (ids < n_live).all(1)
    ok &= np.isfinite(ans.dists).all(1)
    s = np.sort(ids, axis=1)
    ok &= ~(s[:, 1:] == s[:, :-1]).any(1)
    return ok


def _exact(ans: Answers, ok, rows_t, metric, device) -> np.ndarray:
    """f64 distances [valid answers, k] of the returned rows; each
    distinct (query, row) pair is recomputed once."""
    ids = ans.ids[ok]
    q = np.repeat(ans.q_idx[ok], ids.shape[1])
    n = np.int64(rows_t.shape[0])
    uniq, inv = np.unique(q * n + ids.reshape(-1), return_inverse=True)
    d64 = reference.pair_distances(
        rows_t, ans.queries, uniq // n, uniq % n, metric, device)
    return d64[inv.reshape(-1)].reshape(ids.shape)


def _rel_err(ans: Answers, ok, d64) -> float:
    if not ok.any():
        return 0.0
    d = ans.dists[ok].astype(np.float64)
    return float((np.abs(d - d64) / np.maximum(np.abs(d64), DIST_FLOOR)).max())


def recall(ans: Answers, ok, d64, truth_ids, truth_d) -> float:
    """Tie-aware recall of the pool's answers (invalid answers score 0)."""
    k = truth_ids.shape[1]
    if len(ans.q_idx) == 0:
        return 0.0
    qi = ans.q_idx[ok]
    ids = ans.ids[ok]
    near = d64 <= truth_d[qi, -1][:, None] * (1 + 1e-12)
    member = (ids[:, :, None] == truth_ids[qi][:, None, :]).any(-1)
    hits = np.minimum((near | member).sum(1), k).sum()
    return float(hits / (k * len(ans.q_idx)))


def judge(config: dict, rows: np.ndarray, pool: Answers,
          readback: Answers | None, device) -> dict:
    """The compared numbers of one run: {name: value}. ``rows`` are the
    live rows (row id = index); ``pool`` holds every answer to a pool
    query; ``readback`` the self-searches of sampled inserted rows."""
    metric = config["metric"]
    k = config["k"]
    rows_t = torch.as_tensor(rows, device=device)
    ok = _valid(pool, len(rows))
    d64 = _exact(pool, ok, rows_t, metric, device)
    out = {"missing": int((~ok).sum()),
           "dist_rel_err": _rel_err(pool, ok, d64)}
    asked = np.unique(pool.q_idx[ok])
    truth_ids = np.zeros((len(pool.queries), k), np.int64)
    truth_d = np.zeros(truth_ids.shape)
    if len(asked):
        truth_ids[asked], truth_d[asked] = reference.exact_topk(
            rows_t, pool.queries[asked], k, metric, device)
    out["recall_at_10"] = recall(pool, ok, d64, truth_ids, truth_d)
    if readback is not None:
        rok = _valid(readback, len(rows))
        out["missing"] += int((~rok).sum())
        rd64 = _exact(readback, rok, rows_t, metric, device)
        out["dist_rel_err"] = max(out["dist_rel_err"],
                                  _rel_err(readback, rok, rd64))
        found = (readback.ids == readback.own[:, None]).any(1)
        out["unread"] = int((~found).sum())
    return out


def checks(config: dict, numbers: dict) -> dict:
    """{name: {"value", "op", "limit"}} for every number compared."""
    out = {}
    for name, value in numbers.items():
        lim = config["correct"][name]
        op, limit = ("<=", lim["max"]) if "max" in lim else (">=", lim["min"])
        out[name] = {"value": value, "op": op, "limit": limit}
    return out


def holds(check: dict) -> bool:
    v, lim = check["value"], check["limit"]
    return v <= lim if check["op"] == "<=" else v >= lim
