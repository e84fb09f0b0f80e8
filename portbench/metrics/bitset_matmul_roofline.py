"""``bitset_matmul_roofline``: B1 ``bitset_matmul`` (``ops.frontier_step``),
its share of the logical-byte bandwidth bound over the traced stretch
(see ``kernel_bytes``)."""
from portbench.metrics import kernel_bytes


def read(run):
    return kernel_bytes.roofline(run, "bitset_matmul")
