"""The port's hop roofline against the JAX package's: ``edge_code_bytes``
and ``hop_roofline`` equal for every edge type a GraphParams can be made
with (both sides built from one set of options, the bandwidth passed
explicitly), and the card table of ``device_hbm_gbps``.
"""

import dataclasses

import pytest

from duckdb_lm_diskann_tpu.common.types import VectorType as JaxVectorType
from duckdb_lm_diskann_tpu.core.graph import GraphParams as JaxGraphParams
from duckdb_lm_diskann_tpu.utils import roofline as jax_roofline
from duckdb_lm_diskann_tpu_torch.common.types import VectorType
from duckdb_lm_diskann_tpu_torch.core.graph import GraphParams
from duckdb_lm_diskann_tpu_torch.utils import roofline
from tests.torch_configs import configs

# (metric, edge type): every codec, each under a metric it accepts.
EDGES = [
    ("cosine", "ternary"), ("ip", "ternary"), ("l2", "int8"), ("l2", "int4"),
    ("l2", "float32"), ("l2", "float16"), ("cosine", "float1bit"),
    ("cosine", "none"),
]


@pytest.mark.parametrize("dims", [128, 100, 960])
@pytest.mark.parametrize("metric,edge", EDGES)
def test_hop_roofline_matches_jax(metric, edge, dims):
    jax_cfg, port_cfg = configs(metric=metric, edge_type=edge, dims=dims,
                                r=64, l_insert=128, l_search=100)
    jp, pp = JaxGraphParams.from_config(jax_cfg), GraphParams.from_config(port_cfg)
    pairs = [(jp, pp)]
    if edge == "int4":  # INT8 node vectors change the vector term
        pairs.append((
            dataclasses.replace(jp, node_vtype=JaxVectorType.INT8),
            dataclasses.replace(pp, node_vtype=VectorType.INT8),
        ))
    for j, p in pairs:
        assert roofline.edge_code_bytes(p) == jax_roofline.edge_code_bytes(j)
        for kw in (
            dict(batch=1024, l_search=100, hbm_gbps=3350.0),
            dict(batch=256, l_search=128, beam_width=2, mean_visits=133.5,
                 hbm_gbps=2000.0),
        ):
            got = roofline.hop_roofline(p, **kw)
            want = jax_roofline.hop_roofline(j, **kw)
            assert got.as_dict() == want.as_dict()
            assert (got.gather_bytes, got.state_bytes, got.flops) == (
                want.gather_bytes, want.state_bytes, want.flops
            )
            assert got.sol_hop_us == pytest.approx(want.sol_hop_us, rel=1e-12)
            assert got.sol_qps == pytest.approx(want.sol_qps, rel=1e-12)


def test_device_hbm_gbps_reads_the_card_name():
    assert roofline.device_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert roofline.device_hbm_gbps("NVIDIA H100 PCIe") == 2000.0
    assert roofline.device_hbm_gbps("some other card") == 3350.0
    # No TPU figure is the port's.
    assert roofline.device_hbm_gbps("TPU v5 lite") == 3350.0
