"""ms_per_hop.search: the search loop (core/coordinator.py ->
core/searcher.py). The summed ``Coordinator.search`` wall time of the
batched calls over their summed ``SearchStats.hops``, in ms."""

from lmdbench import readers


def read(run):
    return readers.ms_per_hop(run, "search.call")
