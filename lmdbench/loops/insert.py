"""``insert``: ``Coordinator.insert`` of ``chunk`` fresh stream rows at a
time into an index bulk-built from the configuration's ``rows``. Each
chunk is drawn before its timed span, so the span holds the insert and the
card's synchronisation alone. After the window ``readback`` sampled
inserted rows are searched for and the pool is searched in batches of
``batch``."""

from __future__ import annotations

import numpy as np

from ..judge import Answers
from . import Loop as _Base
from . import built_coordinator


class Loop(_Base):
    span = "insert.chunk"
    rate = "insert_rows_per_s"

    def setup(self) -> None:
        import torch

        self._sync = (torch.cuda.synchronize if self.device != "cpu"
                      else lambda: None)
        self.coord = built_coordinator(self.config, self.traffic,
                                       self.inputs.base, self.device)
        self.n_inserted = 0
        self.readback = None

    def prepare(self, i: int) -> None:
        a = self.n_inserted
        self.rows = self.inputs.stream_slice(a, a + self.traffic["chunk"])

    def call(self, i: int) -> dict:
        c = len(self.rows)
        first = len(self.inputs.base) + self.n_inserted
        self.coord.insert(range(first, first + c), self.rows)
        self._sync()
        self.n_inserted += c
        return {"n": c}

    def finish(self) -> None:
        n_base = len(self.inputs.base)
        rng = np.random.default_rng(self.seed)
        own = np.sort(rng.choice(
            np.arange(n_base, n_base + self.n_inserted),
            min(self.traffic["readback"], self.n_inserted), replace=False))
        rows = self.live_rows()[own]
        ids, dists = self.coord.search(rows, self.k,
                                       l_search=self.config["l_search"])
        self.readback = Answers(rows, np.arange(len(own)), ids, dists, own)
        b = self.traffic["batch"]
        pool = self.inputs.pool
        for a in range(0, len(pool), b):
            q = np.arange(a, min(a + b, len(pool)))
            ids, dists = self.coord.search(pool[q], self.k,
                                           l_search=self.config["l_search"])
            self.parts.append((q, ids, dists))

    def answers(self):
        pool = Answers.join(self.inputs.pool, self.parts, self.k)
        return pool, self.readback

    def live_rows(self) -> np.ndarray:
        return self.inputs.rows(len(self.inputs.base) + self.n_inserted)
