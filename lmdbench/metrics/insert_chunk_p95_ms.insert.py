"""insert_chunk_p95_ms.insert: the build (core/builder.py via
``Coordinator.insert``). The 95th percentile of the harness span around
each chunk's ``insert`` call, ended by ``torch.cuda.synchronize()``, in
ms: the stalls that a rate hides."""

from lmdbench import readers


def read(run):
    return readers.p95_ms(run, "insert.chunk")
