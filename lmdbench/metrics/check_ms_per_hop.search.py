"""check_ms_per_hop.search: the search loop's condition reads
(core/searcher.py). The host seconds of the program's ``search.check``
spans in the traced ``Coordinator.search`` calls over their ``search.hop``
count, in ms: the host's time blocked on the card, per hop."""

from lmdbench import spans


def read(run):
    return spans.per_hop_ms(run, "search.check")
