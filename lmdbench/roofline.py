"""The yardstick's peaks and byte counts.

A kernel's roofline share is the least time the card could take for the
work the inputs need, over the time the kernel took. The frontier scorers
do under two operations a byte, so the bytes bound them: each input byte
read once, each output byte written once. Only the visits the search made
(``SearchStats.nodes_visited``) are counted: lanes that have converged and
that a kernel still scores are work the inputs do not need. The edge-code
arithmetic is the gather arithmetic of the program's
``utils/roofline.edge_code_bytes``, copied and frozen here; the program's
beam and merge working set is left out, because it is the current
implementation's and not the work's.
"""

from __future__ import annotations

# Published HBM bandwidth (bytes/s) by a substring of the card's name: the
# H100 SXM's HBM3 (NVIDIA's data sheet, at the full power limit), the
# card every cell runs on.
HBM_BYTES_PER_S = (
    ("h100 80gb hbm3", 3.35e12),
)


def hbm_bytes_per_s(device_name: str) -> float | None:
    name = device_name.lower()
    for key, bw in HBM_BYTES_PER_S:
        if key in name:
            return bw
    return None


def int4_frontier_bytes(visits: int, queries: int, r: int, d: int) -> int:
    """Per visit: R INT4 codes of ceil(D/2) bytes and an f32 scale each,
    R f32 scores out; per query of a call: its f32 vector."""
    return visits * (r * ((d + 1) // 2 + 4) + r * 4) + queries * 4 * d


def ternary_frontier_bytes(visits: int, queries: int, r: int, d: int) -> int:
    """Per visit: R pairs of ceil(D/32)-word sign planes, R i32 scores out;
    per query of a call: its own pair of planes."""
    w = (d + 31) // 32
    return visits * (r * 2 * w * 4 + r * 4) + queries * 2 * w * 4
