"""merge_ms_per_hop.search: the search loop's merge (core/searcher.py
``_hop``). The host seconds of the program's ``search.hop.merge`` spans in
the traced ``Coordinator.search`` calls over their ``search.hop`` count, in
ms: the skip masks and the merge into the beam."""

from lmdbench import spans


def read(run):
    return spans.per_hop_ms(run, "search.hop.merge")
