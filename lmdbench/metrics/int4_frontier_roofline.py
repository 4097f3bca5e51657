"""int4_frontier_roofline: the INT4 frontier kernel (csrc/int4_frontier.cu)
in the batched searches. The bytes the traced calls' visits need
(``roofline.int4_frontier_bytes``) over the HBM bandwidth, over the device
time of ``int4_frontier_kernel*``, in %."""

from lmdbench import readers, roofline


def read(run):
    return readers.kernel_roofline(run, "int4_frontier_kernel", "search.call",
                                   roofline.int4_frontier_bytes)
