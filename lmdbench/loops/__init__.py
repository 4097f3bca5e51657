"""The one traffic generator: a mix's data file names a loop kind and its
parameters, and the loop drives the program through its public entries.
Each kind is a file of its own, ``loops/<kind>.py``, that defines
``Loop``; ``registry.loop`` finds it by the mix's ``kind``.

Every kind is a closed loop with one client: the next call goes out when
the last one has returned. A loop object has

    setup()      builds the index through the program's normal entry
    prepare(i)   readies call i's inputs, outside its timed span
    call(i)      one timed call (i < 0: a warm-up call, not recorded)
    finish()     untimed program calls whose answers are judged too
    answers()    (pool answers, read-back answers or None)
    live_rows()  the rows the index holds (row id = index)
    free()       drops the program's state
"""

from __future__ import annotations

import numpy as np

from ..judge import Answers


def index_config(config: dict):
    from duckdb_lm_diskann_tpu_torch.common.types import (
        EdgeType, MetricType, VectorType)
    from duckdb_lm_diskann_tpu_torch.core.config import LmDiskannConfig

    cfg = LmDiskannConfig(
        metric_type=MetricType.parse(config["metric"]), r=config["r"],
        l_insert=config["l_insert"], alpha=config["alpha"],
        l_search=config["l_search"], dimensions=config["dims"],
        node_vector_type=VectorType(config["node_vector_type"]),
        edge_type=EdgeType.parse(config["edge_type"]),
    )
    cfg.validate()
    return cfg


def built_coordinator(config: dict, traffic: dict, base, device):
    """A Coordinator of at least the mix's ``capacity`` slots, bulk-built
    from ``base`` (row id = row index) in the configuration's batches."""
    from duckdb_lm_diskann_tpu_torch.core.coordinator import Coordinator

    coord = Coordinator(
        index_config(config),
        initial_capacity=max(len(base), traffic.get("capacity", 0)),
        device=device,
    )
    coord.bulk_build(range(len(base)), base, max_batch=config["build_batch"])
    return coord


class Loop:
    span = ""
    rate = ""

    def __init__(self, config, traffic, inputs, seed, device):
        self.config = config
        self.traffic = traffic
        self.inputs = inputs
        self.seed = seed
        self.device = device
        self.k = config["k"]
        self.parts = []

    def prepare(self, i: int) -> None:
        pass

    def finish(self) -> None:
        pass

    def answers(self):
        return Answers.join(self.inputs.pool, self.parts, self.k), None

    def live_rows(self) -> np.ndarray:
        return self.inputs.base

    def free(self) -> None:
        self.__dict__.pop("coord", None)
