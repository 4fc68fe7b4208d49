"""Device µs a training iteration in every kernel outside the Cholesky,
triangular-solve and matmul classes: the elementwise and reduction kernels
of the ELBO, the kernel matrices and Adam."""


def read(w):
    if w.kind != "train" or not w.kernels:
        return None
    return w.by_class().get("other", 0.0) / w.units
