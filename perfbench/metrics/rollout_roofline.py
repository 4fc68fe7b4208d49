"""The rollout kernel's share of its roofline, in %: the least time its
launches could take on the card, the larger of their operations over the
float32 peak and their compulsory bytes over HBM bandwidth, over the
kernel's device time.  At every shape of the benchmark the operations
bound it (``bound`` says which)."""

from perfbench.harness.peaks import peak

NAME = "rollout_kernel"


def work(rows: int, steps: int, d: int, m: int, din: int, cu: int,
         sets: int, itemsize: int):
    """(operations, bytes) of one launch: ``rows`` rollouts of ``steps``
    steps over ``sets`` distinct parameter sets.  Per row and step:
    the scaled differences, squares and exp of K(x̃, Z) (d·m·(4·din + 2)),
    σ²Lm⁻¹·k and q_sqrtᵀ·a on the triangles (4·d·m(m+1)/2 each counted as
    multiply and add), a·U, a² and (q_sqrtᵀa)² (3·d·m), three reductions
    over M (3·d·m), the variance, clamp, square root and update (8·d).
    Bytes: the starts, each distinct parameter set (Z/ℓ, 1/ℓ, σ², the two
    triangles, U, Q) and the controls read once, the trajectories and
    variances written once; the noise is made in the kernel.  (The
    operations and bytes of ``chip_smoke.py::_bound``.)"""
    tri = d * m * (m + 1) // 2
    per_step = (d * m * (4 * din + 2) + 2 * 2 * tri + d * m * 3 + 3 * d * m
                + 8 * d)
    params = d * m * din + d * din + d + 2 * tri + m * d + d
    elems = rows * d + params * sets + steps * cu + 2 * rows * steps * d
    return rows * steps * per_step, elems * itemsize


def bound(w):
    """(least seconds of one evaluation's launches, "operations" or
    "bytes"), or None for a card without peaks."""
    flops, nbytes = peak(w.device_name, "fp32_flops"), peak(
        w.device_name, "hbm_bytes")
    if flops is None:
        return None
    k, t_ops, t_bytes = w.work, 0.0, 0.0
    for launch in k["launches"]:
        ops, b = work(launch["rows"], launch["steps"], k["d"], k["m"],
                      k["din"], k["cu"], launch["sets"], k["itemsize"])
        t_ops, t_bytes = t_ops + ops / flops, t_bytes + b / nbytes
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def read(w):
    if w.kind != "eval":
        return None
    b, us = bound(w), w.device_us(lambda n: NAME in n)
    if b is None or us <= 0:
        return None
    return 100.0 * b[0] * w.units / (us * 1e-6)
