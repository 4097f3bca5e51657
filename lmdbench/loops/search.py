"""``search``: ``Coordinator.search(pool[batch], k, l_search,
**search_options)`` in batches of ``batch`` queries that cycle the pool in
order. ``search_options`` (optional in the mix) are further keyword
arguments of ``Coordinator.search`` given as data, such as ``stream`` and
``lanes``."""

from __future__ import annotations

import numpy as np

from . import Loop as _Base
from . import built_coordinator


class Loop(_Base):
    span = "search.call"
    rate = "search_qps"

    def setup(self) -> None:
        self.coord = built_coordinator(self.config, self.traffic,
                                       self.inputs.base, self.device)

    def call(self, i: int) -> dict:
        b = self.traffic["batch"]
        q = (i * b + np.arange(b)) % len(self.inputs.pool)
        ids, dists = self.coord.search(
            self.inputs.pool[q], self.k, l_search=self.config["l_search"],
            **self.traffic.get("search_options", {}))
        st = self.coord.last_search_stats
        if i >= 0:
            self.parts.append((q, ids, dists))
        return {"n": b, "hops": st.hops, "visits": st.nodes_visited,
                "search_s": st.wall_time_s}
