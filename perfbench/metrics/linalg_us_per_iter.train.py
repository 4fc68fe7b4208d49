"""Device µs a training iteration in the Cholesky, triangular-solve and
matmul kernels (cuSOLVER, cuBLAS; classed by name as
``harness.trace.KERNEL_CLASSES``)."""

LINALG = ("cholesky", "trsm", "gemm")


def read(w):
    if w.kind != "train" or not w.kernels:
        return None
    by = w.by_class()
    return sum(by.get(c, 0.0) for c in LINALG) / w.units
