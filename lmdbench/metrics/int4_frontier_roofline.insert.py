"""int4_frontier_roofline.insert: the INT4 frontier kernel
(csrc/int4_frontier.cu) in the build's candidate searches. The bytes the
visits of the traced calls' ``insert.candidates`` spans need
(``roofline.int4_frontier_bytes``) over the HBM bandwidth, over the device
time of ``int4_frontier_kernel*``, in %: ``int4_frontier_roofline``'s
yardstick."""

import types

from lmdbench import readers, roofline, spans


def read(run):
    call = spans.candidate_search(run)
    if call is None:
        return None
    searches = types.SimpleNamespace(
        calls=[call], trace=run.trace, config=run.config,
        device_name=run.device_name)
    return readers.kernel_roofline(searches, "int4_frontier_kernel",
                                   "insert.candidates",
                                   roofline.int4_frontier_bytes)
