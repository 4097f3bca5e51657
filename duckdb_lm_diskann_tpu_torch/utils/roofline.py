"""Analytic roofline accounting for the beam-search hop loop.

The port's copy of ``duckdb_lm_diskann_tpu/utils/roofline.py`` (the port
imports nothing of the JAX package), with the device table of the card the
port runs on. Frontier scoring is far below the card's arithmetic
intensity (R-way dot products per gathered row, under 2 operations a byte
for every edge codec), so the model counts the bytes a hop must move:

    node vectors    B*E*D*vec_bytes      (exact re-rank of each visit)
    neighbor ids    B*E*R*4
    valid mask      B*E*R*1
    edge codes      B*E*R*edge_bytes     (cached neighbor codes)

plus the per-hop beam/sort working set (read+write of the beam and the
merge buffer), which bounds how low a perfectly fused hop could go. Real
hops also pay per-op launch overheads the model leaves out: ``sol_qps``
over a measured QPS is the headroom left for kernel-level work.

Device figures are the data sheets' nominal HBM rates; pass ``hbm_gbps``
to override.
"""

from __future__ import annotations

import dataclasses

from ..common.types import EdgeType, VectorType
from ..core.graph import GraphParams

# Nominal HBM bandwidth (GB/s) by a substring of
# torch.cuda.get_device_name(): the H100 SXM's HBM3 and the H100 PCIe's
# HBM2e (NVIDIA's data sheets). More specific keys come first.
DEVICE_HBM_GBPS = {
    "h100 pcie": 2000.0,
    "h100": 3350.0,
}
DEFAULT_HBM_GBPS = 3350.0  # the H100 SXM


def edge_code_bytes(params: GraphParams) -> int:
    """Bytes of cached edge code gathered per (visit, neighbor)."""
    et = params.edge_type
    d = params.dims
    w_bytes = params.words * 4  # u32 words per ternary plane
    if et is EdgeType.TERNARY:
        return 2 * w_bytes
    if et is EdgeType.FLOAT1BIT:
        return w_bytes
    if et is EdgeType.INT8:
        return d + 4  # codes + f32 scale
    if et is EdgeType.INT4:
        return (d + 1) // 2 + 4
    if et is EdgeType.FLOAT32:
        return 4 * d
    if et is EdgeType.FLOAT16:
        return 2 * d
    if et is EdgeType.NONE:
        return 4 * d  # gathers the neighbor's own full vector instead
    raise ValueError(et)


@dataclasses.dataclass(frozen=True)
class HopRoofline:
    gather_bytes: int  # irreducible graph-data reads per hop
    state_bytes: int  # beam/merge working set (read+write) per hop
    flops: int  # useful arithmetic per hop
    sol_hop_us: float  # speed-of-light hop time at the given bandwidth
    sol_qps: float  # speed-of-light throughput for the whole search

    def as_dict(self) -> dict:
        return {
            "gather_bytes_per_hop": self.gather_bytes,
            "state_bytes_per_hop": self.state_bytes,
            "flops_per_hop": self.flops,
            "sol_hop_us": round(self.sol_hop_us, 2),
            "sol_qps": round(self.sol_qps, 1),
        }


def hop_roofline(
    params: GraphParams,
    *,
    batch: int,
    l_search: int,
    beam_width: int = 1,
    mean_visits: float | None = None,
    hbm_gbps: float = DEFAULT_HBM_GBPS,
) -> HopRoofline:
    """Per-hop byte/FLOP accounting + speed-of-light QPS.

    ``mean_visits`` is the measured mean visited nodes per query (defaults
    to l_search + 4, the L + epsilon of converged beams); hops per query =
    mean_visits / beam_width (each hop visits ``beam_width`` nodes).
    """
    B, E, R, D, L = batch, beam_width, params.r, params.dims, l_search
    vec_bytes = 1 if params.node_vtype is VectorType.INT8 else 4

    gather = B * E * (D * vec_bytes + R * 4 + R * 1 + R * edge_code_bytes(params))

    # Beam state (dist f32 + slot i32 + vis byte) read+written, plus the
    # sorted-merge buffer of L + E*R keyed triples (dist, slot, vis-i32).
    beam_state = B * L * (4 + 4 + 1) * 2
    merge_buf = B * (L + E * R) * 12 * 2
    state = beam_state + merge_buf

    # Useful arithmetic: exact distance to each visit (2*D) + edge scoring
    # (~2*D per neighbor for dequant codecs; popcount algebra counted as 1
    # op per word-op: TERNARY does 4 AND+popcount plane pairs, FLOAT1BIT
    # one XOR+popcount).
    if params.edge_type is EdgeType.TERNARY:
        edge_flops = B * E * R * params.words * 4
    elif params.edge_type is EdgeType.FLOAT1BIT:
        edge_flops = B * E * R * params.words * 2
    else:
        edge_flops = B * E * R * 2 * D
    flops = B * E * 2 * D + edge_flops

    bw = hbm_gbps * 1e9
    sol_hop_s = (gather + state) / bw
    mv = mean_visits if mean_visits is not None else L + 4.0
    hops_per_query = max(1.0, mv / E)
    sol_qps = B / (hops_per_query * sol_hop_s) if sol_hop_s > 0 else 0.0
    return HopRoofline(
        gather_bytes=int(gather),
        state_bytes=int(state),
        flops=int(flops),
        sol_hop_us=sol_hop_s * 1e6,
        sol_qps=sol_qps,
    )


def device_hbm_gbps(device_name: str) -> float:
    """Nominal HBM bandwidth of a ``torch.cuda.get_device_name()`` string;
    the H100 SXM's for a name the table does not know."""
    name = device_name.lower()
    for key, bw in DEVICE_HBM_GBPS.items():
        if key in name:
            return bw
    return DEFAULT_HBM_GBPS
