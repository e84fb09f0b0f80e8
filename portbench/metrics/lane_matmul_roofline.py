"""``lane_matmul_roofline``: B4 ``lane_matmul`` (``ops.frontier_step_lanes``),
its share of the logical-byte bandwidth bound over the traced stretch
(see ``kernel_bytes``)."""
from portbench.metrics import kernel_bytes


def read(run):
    return kernel_bytes.roofline(run, "lane_matmul")
