"""``block_sparse_matmul_roofline``: B3 ``block_sparse_matmul`` (``ops.frontier_step_sparse``),
its share of the logical-byte bandwidth bound over the traced stretch
(see ``kernel_bytes``)."""
from portbench.metrics import kernel_bytes


def read(run):
    return kernel_bytes.roofline(run, "block_sparse_matmul")
