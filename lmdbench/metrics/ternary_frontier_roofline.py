"""ternary_frontier_roofline: the TERNARY frontier kernel
(csrc/ternary_frontier.cu) in the batched searches. The bytes the traced
calls' visits need (``roofline.ternary_frontier_bytes``) over the HBM
bandwidth, over the device time of ``ternary_frontier_kernel*``, in %."""

from lmdbench import readers, roofline


def read(run):
    return readers.kernel_roofline(run, "ternary_frontier_kernel",
                                   "search.call",
                                   roofline.ternary_frontier_bytes)
