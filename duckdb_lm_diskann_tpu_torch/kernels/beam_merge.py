"""The beam merge of one search hop: a hand-written Hopper kernel and its
plain form.

``beam_merge`` takes every lane's (distance, slot)-sorted beam and the E x R
candidates the hop scored, drops the candidates already in the beam or
among the lane's visited seeds, merges the rest into the beam, keeps the
best L in (distance, slot) order with their visited flags, and sets the
slot of every infinite entry to -1. At E > 1 it also keeps one copy of a
slot offered twice (``merge_beams(dedup=True)``): the decision is read from
the candidates' shape [B, E, R]. The beam tensors are written in place and
returned.

It replaces no TPU kernel: the JAX package leaves the merge to XLA's sort
(``duckdb_lm_diskann_tpu/ops/topk.py::merge_beams``). The kernel exists
because the port's hop is bound by the host's launches, and the merge was
about 30 of them; its work is a few KB per query. The CUDA source is
``csrc/beam_merge.cu``.

Dispatch follows the tensors, never a switch: CPU tensors take the plain
PyTorch version (the membership masks, ``mask_invalid``, the stable-sort
``merge_beams``, the slot normalisation) and copy its result into the beam;
CUDA tensors launch the kernel or raise. The two are bit-identical.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import topk as topk_ops
from ._build import BLOCK_SHARED_BYTES, KernelLibrary, check_tensors, launch

LIBRARY = KernelLibrary(
    "beam_merge", "lmd_beam_merge",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
)
THREADS = 256  # the kernel's kThreads (csrc/beam_merge.cu)

# Kernel launches since the last reset (chip_smoke.py reads and resets it).
LAUNCHES = 0


def smem_bytes(L: int, C: int, S: int) -> int:
    """One block's dynamic shared memory (csrc/beam_merge.cu, smem_bytes)."""
    n = L + C
    return n * (8 + 8 + 4 + 4 + 4) + C * 4 + S * 4 + n + S


def beam_merge_plain(beam_dist, beam_slot, beam_vis, nbrs, edge_dist, live,
                     seeds_b, seed_vis):
    """Plain PyTorch version; returns new (beam_dist, beam_slot,
    beam_vis)."""
    B, L = beam_slot.shape
    _, E, R = nbrs.shape
    nbrs = nbrs.reshape(B, E * R)
    # Skip neighbors already in the beam or already-visited seeds (see the
    # JAX searcher for why this replaces the visited-list scan). Edges to
    # this hop's own visits are in the beam, so in_beam covers them.
    in_beam = (
        (nbrs[:, :, None] == beam_slot[:, None, :])
        & (beam_slot >= 0)[:, None, :]
    ).any(-1)
    in_vis_seed = (
        (nbrs[:, :, None] == seeds_b[:, None, :]) & seed_vis[:, None, :]
    ).any(-1)
    cand_ok = live.reshape(B, E * R) & ~in_beam & ~in_vis_seed
    cand_dist, cand_slot = topk_ops.mask_invalid(
        edge_dist.reshape(B, E * R), nbrs, cand_ok
    )
    # E > 1: two visited nodes may offer the same neighbor; the dedup merge
    # keeps one copy (the same cached code, so the same distance).
    beam_dist, beam_slot, beam_vis = topk_ops.merge_beams(
        beam_dist, beam_slot, cand_dist, cand_slot, L,
        extras_a=(beam_vis,), extras_b=(torch.zeros_like(cand_ok),),
        dedup=E > 1,
    )
    # Entries that sorted to +inf are empty; normalize their slot to -1.
    beam_slot = torch.where(
        torch.isinf(beam_dist), torch.full_like(beam_slot, -1), beam_slot
    )
    return beam_dist, beam_slot, beam_vis


def _check(beam_dist, beam_slot, beam_vis, nbrs, edge_dist, live, seeds_b,
           seed_vis) -> torch.device:
    dev = check_tensors([
        ("beam_dist", beam_dist, torch.float32, 2),
        ("beam_slot", beam_slot, torch.int32, 2),
        ("beam_vis", beam_vis, torch.bool, 2),
        ("nbrs", nbrs, torch.int32, 3),
        ("edge_dist", edge_dist, torch.float32, 3),
        ("live", live, torch.bool, 3),
        ("seeds_b", seeds_b, torch.int32, 2),
        ("seed_vis", seed_vis, torch.bool, 2),
    ])
    B, L = beam_slot.shape
    _, E, R = nbrs.shape
    S = seeds_b.shape[1]
    shapes = {
        "beam_dist": (beam_dist, (B, L)), "beam_vis": (beam_vis, (B, L)),
        "nbrs": (nbrs, (B, E, R)), "edge_dist": (edge_dist, (B, E, R)),
        "live": (live, (B, E, R)), "seed_vis": (seed_vis, (B, S)),
        "seeds_b": (seeds_b, (B, S)),
    }
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want}")
    if L < 1 or E * R < 1:
        raise ValueError(f"an empty beam ({L}) or no candidates ({E * R})")
    if smem_bytes(L, E * R, S) > BLOCK_SHARED_BYTES:
        raise ValueError(
            f"a lane of L={L}, {E * R} candidates, {S} seeds needs "
            f"{smem_bytes(L, E * R, S)} bytes of shared memory"
        )
    return dev


def beam_merge(
    beam_dist: torch.Tensor,  # f32[B, L] sorted by (distance, slot)
    beam_slot: torch.Tensor,  # i32[B, L] (-1 where empty)
    beam_vis: torch.Tensor,  # bool[B, L]
    nbrs: torch.Tensor,  # i32[B, E, R] the visited nodes' neighbor slots
    edge_dist: torch.Tensor,  # f32[B, E, R] their approximate distances
    live: torch.Tensor,  # bool[B, E, R]
    seeds_b: torch.Tensor,  # i32[B, S]
    seed_vis: torch.Tensor,  # bool[B, S]
):
    """Merge the hop's candidates into the beam, in place; returns
    (beam_dist, beam_slot, beam_vis). CPU tensors: the plain version. CUDA
    tensors: the kernel, or an exception."""
    global LAUNCHES
    args = (beam_dist, beam_slot, beam_vis, nbrs, edge_dist, live, seeds_b,
            seed_vis)
    if _check(*args).type == "cpu":
        for t, new in zip(args[:3], beam_merge_plain(*args)):
            t.copy_(new)
        return beam_dist, beam_slot, beam_vis
    B, L = beam_slot.shape
    _, E, R = nbrs.shape
    if B == 0:
        return beam_dist, beam_slot, beam_vis
    launch(LIBRARY, args, (B, L, E * R, seeds_b.shape[1], int(E > 1)))
    LAUNCHES += 1
    return beam_dist, beam_slot, beam_vis
