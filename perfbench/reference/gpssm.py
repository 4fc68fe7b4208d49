"""Plain PyTorch reference of the collapsed GP state-space model (FFVD case
C4) that the benchmark holds the port against.

It follows the published model (Fan et al., "Free-Form Variational
Inference for Gaussian Process State-Space Models", ICML 2023,
arXiv:2302.09921, and its code, github.com/xuhuifan/FFVD) from the raw data
and warm-start files, with no kernel, cache, batching or graph:

- the six system-identification series: control z-normalised over the whole
  series, observations over the training half, a 50/50 chronological split;
- the parameters of a ``Factnonlin`` warm start (x0 and the posterior-mean
  trajectory, whitened U, Z, SE-ARD log hyperparameters, log Q, C, d, the
  emission noise's log Cholesky), and the growth of the inducing set to M
  points drawn from the trajectory's states (``resize_inducing``);
- the negative collapsed free-form ELBO with q(U) integrated out, its
  gradient by autograd, and Adam at the FFVD learning rate;
- the collapsed q(U) = N(H⁻¹a, H⁻¹), and the free-running rollout
  x ← x + μ(x̃) + √max(σ²(x̃) + Q, 0)·ε over the test half, with ε from
  Philox4x32-10 keyed by a seed (``philox_normals``);
- the emission moments of the rollouts, and the RMSE and NLL over the
  first ``horizon`` test steps (30 as published).

Every function takes its dtype and device from its tensors.  The
benchmark runs it in float64 with TF32 off as the truth, and in float32
with TF32 on as the control.  It imports nothing of the program.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Leaves = Dict[str, torch.Tensor]

# Leaf names and order; the collapsed case trains every leaf but u.
LEAVES = ("x", "u", "z", "kernel.log_variance", "kernel.log_lengthscales",
          "log_q", "c", "d", "log_rchol")
TRAINED = tuple(k for k in LEAVES if k != "u")

# Raw files of the six series: (file, layout).  "dat": whitespace columns
# u, y; "csv": a header, then u, y; "mat": MATLAB variables (u, y).
SERIES = {
    "ballbeam": ("ballbeam.dat", "dat", None),
    "dryer": ("dryer.dat", "dat", None),
    "flutter": ("flutter.dat", "dat", None),
    "gas_furnace": ("gas_furnace.csv", "csv", None),
    "actuator": ("actuator.mat", "mat", ("u", "p")),
    "drive": ("drive.mat", "mat", ("u1", "z1")),
}

JITTER = 1e-5            # on Kmm
RETRY_JITTER = 1e-4      # a Cholesky that fails is retried with this
ADAM = dict(lr=0.003 * 0.95 ** (1.0 / 1000.0), b1=0.9, b2=0.999, eps=1e-8)
GRAD_CLIP = 1e6          # non-finite gradient entries → 0, then ±clip
HORIZON = 30             # test steps of the RMSE and NLL


# ---------------------------------------------------------------------------
# Inputs: series, warm starts, the grown inducing set
# ---------------------------------------------------------------------------

def load_series(root: Path, name: str) -> dict:
    """y_train (N, 1), y_test, control (2N or so, U), y_train_std."""
    fname, layout, keys = SERIES[name]
    path = Path(root) / fname
    if layout == "dat":
        arr = np.loadtxt(path)
        u, y = arr[:, 0:1], arr[:, 1:2]
    elif layout == "csv":
        arr = np.genfromtxt(path, delimiter=",", skip_header=1)
        u, y = arr[:, 0:1], arr[:, 1:2]
    else:
        import scipy.io
        mat = scipy.io.loadmat(path)
        u, y = (np.asarray(mat[k], np.float64) for k in keys)
    u, y = np.asarray(u, np.float64), np.asarray(y, np.float64)
    half = y.shape[0] // 2
    y_mean, y_std = float(np.mean(y[:half])), float(np.std(y[:half]))
    obs = (y - y_mean) / y_std
    return {"y_train": obs[:half], "y_test": obs[half:],
            "control": (u - np.mean(u)) / np.std(u), "y_train_std": y_std}


def warm_start(root: Path, name: str, file_id: int = 3) -> Dict[str, np.ndarray]:
    """The leaves of the ``file_id`` warm start of ``name`` (float64)."""
    manifest = json.loads((Path(root) / "MANIFEST.json").read_text())
    fname = next(f for f, meta in manifest.items()
                 if meta.get("dataset") == name
                 and meta.get("file_id") == file_id)
    with np.load(Path(root) / fname) as ws:
        r = np.atleast_2d(ws["R_chol_val"])
        return {
            "x": np.concatenate([ws["qx1_mu_ini"][None, :],
                                 np.mean(ws["x_samples_training"], axis=1)]),
            "u": ws["Umu_ini"].T.copy(),
            "z": ws["Z_val"].copy(),
            "kernel.log_variance": np.log(ws["kernel_variance"]),
            "kernel.log_lengthscales": np.log(ws["kernel_lengthscales"]),
            "log_q": 2.0 * np.log(ws["Q_sqrt_ini"]),
            "c": ws["C_val"].T.copy(),
            "d": ws["d_val"].copy(),
            "log_rchol": np.tril(r, -1) + np.diag(np.log(np.diagonal(r))),
        }


def resize_inducing(leaves: Dict[str, np.ndarray], m: int, seed: int
                    ) -> Dict[str, np.ndarray]:
    """Grow the inducing set to ``m`` points: each new Z row is a latent
    state drawn from the trajectory, N(0, 1) control columns, plus
    0.1·N(0, 1), with a zero U row; fewer points subsample Z and U.  The
    draws come from ``np.random.RandomState(seed)`` in that order."""
    m0, din = leaves["z"].shape
    if m == m0:
        return leaves
    rng = np.random.RandomState(seed)
    out = dict(leaves)
    if m < m0:
        idx = rng.choice(m0, size=m, replace=False)
        out["z"], out["u"] = leaves["z"][idx], leaves["u"][idx]
        return out
    extra = m - m0
    x = leaves["x"]
    rows = x[rng.choice(x.shape[0], size=extra)]
    ctrl = rng.randn(extra, din - x.shape[1])
    new = np.concatenate([rows, ctrl], axis=1) + 0.1 * rng.randn(extra, din)
    out["z"] = np.concatenate([leaves["z"], new])
    out["u"] = np.concatenate([leaves["u"], np.zeros((extra, x.shape[1]))])
    return out


def as_tensors(leaves: Dict[str, np.ndarray], dtype, device,
               stored=torch.float32) -> Leaves:
    """The leaves as ``dtype`` tensors, each first rounded to the dtype in
    which the configuration stores its parameters."""
    return {k: torch.as_tensor(np.asarray(v), dtype=stored)
            .to(dtype=dtype, device=device) for k, v in leaves.items()}


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def se_kernel(log_var: torch.Tensor, log_ls: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """k_d(a_i, b_j) = σ²_d exp(−½ Σ_k ((a_ik − b_jk)/ℓ_dk)²) → (D, I, J)."""
    ls = torch.exp(log_ls)[:, None, None, :]
    diff = (a[None, :, None, :] - b[None, None, :, :]) / ls
    return torch.exp(log_var)[:, None, None] * torch.exp(
        -0.5 * torch.sum(diff * diff, dim=-1))


def cholesky(mat: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of a batch; one that fails is
    factorised again with RETRY_JITTER·I added, then with
    RETRY_JITTER·max(mean diagonal, 1)·I."""
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    diag_mean = torch.diagonal(mat, dim1=-2, dim2=-1).mean(-1).detach()
    retries = (torch.full_like(diag_mean, RETRY_JITTER),
               RETRY_JITTER * torch.clamp(diag_mean, min=1.0))
    jitter = torch.zeros_like(diag_mean)
    for nxt in (*retries, None):
        low, info = torch.linalg.cholesky_ex(mat + jitter[..., None, None]
                                             * eye)
        bad = (info != 0) | ~torch.isfinite(low).all(-1).all(-1)
        if nxt is None or not bool(bad.any()):
            return low
        jitter = torch.where(bad, nxt, jitter)


def tri_inv(low: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(low.shape[-1], dtype=low.dtype, device=low.device)
    return torch.linalg.solve_triangular(low, eye.expand(low.shape),
                                         upper=False)


def gp_inputs(x: torch.Tensor, control: torch.Tensor) -> torch.Tensor:
    """x̃_t = [x_t, u_t] over the N transitions."""
    n = x.shape[0] - 1
    return torch.cat([x[:n], control[:n]], dim=1)


def projection(p: Leaves, xc: torch.Tensor) -> torch.Tensor:
    """A_d = Lm_d⁻¹ K_d(Z, X̃) (D, M, N), Kmm = K(Z, Z) + JITTER·I."""
    lv, ls, z = p["kernel.log_variance"], p["kernel.log_lengthscales"], p["z"]
    eye = torch.eye(z.shape[0], dtype=z.dtype, device=z.device)
    lm = cholesky(se_kernel(lv, ls, z, z) + JITTER * eye)
    return torch.linalg.solve_triangular(lm, se_kernel(lv, ls, z, xc),
                                         upper=False)


def collapse(a: torch.Tensor, dx: torch.Tensor, q: torch.Tensor):
    """H_d = A_d A_dᵀ/Q_d + I and a_d = A_d Δx_d / Q_d."""
    eye = torch.eye(a.shape[1], dtype=a.dtype, device=a.device)
    h = a @ a.mT / q[:, None, None] + eye
    avec = (a @ dx.T[:, :, None])[..., 0] / q[:, None]
    return h, avec


def emission_log_lik(p: Leaves, y: torch.Tensor, x_next: torch.Tensor
                     ) -> torch.Tensor:
    """Σ_t log N(y_t; x_t C + d, R), the −½ log 2π constant left out as in
    FFVD; R diagonal for one output, full (log-diagonal Cholesky) for
    more."""
    resid = y - (x_next @ p["c"] + p["d"])
    lr = p["log_rchol"]
    if lr.shape[0] == 1:
        sd = torch.exp(torch.diagonal(lr))
        return torch.sum(-0.5 * (resid / sd) ** 2 - torch.log(sd))
    chol = torch.tril(lr, -1) + torch.diag(torch.exp(torch.diagonal(lr)))
    w = torch.linalg.solve_triangular(chol, resid.T, upper=False)
    return (-0.5 * torch.sum(w * w)
            - resid.shape[0] * torch.sum(torch.diagonal(lr)))


def negative_elbo(p: Leaves, y: torch.Tensor, control: torch.Tensor
                  ) -> torch.Tensor:
    """The negative collapsed ELBO over N transitions, per transition."""
    x = p["x"]
    n = x.shape[0] - 1
    q = torch.exp(p["log_q"])
    a = projection(p, gp_inputs(x, control))
    dx = x[1:] - x[:-1]
    h, avec = collapse(a, dx, q)
    lh = cholesky(h)
    half_logdet = torch.sum(torch.log(torch.diagonal(lh, dim1=-2, dim2=-1)))
    v = torch.linalg.solve_triangular(lh, avec[..., None], upper=False)
    quad = -0.5 * torch.sum(v * v)
    var = torch.exp(p["kernel.log_variance"])
    trace = 0.5 * torch.sum((var[:, None] - torch.sum(a * a, dim=1))
                            / q[:, None])
    dyn = torch.sum(0.5 * dx * dx / q + 0.5 * p["log_q"])
    prior = (-0.5 * torch.sum((p["kernel.log_variance"] - math.log(0.05)) ** 2)
             - 0.5 * torch.sum(p["kernel.log_lengthscales"] ** 2)
             - 0.5 * torch.sum(p["log_q"] ** 2)
             - 0.5 * torch.sum(p["z"] ** 2)
             - 0.5 * torch.sum(x[0] ** 2)
             - 0.5 * torch.sum(p["c"] ** 2) - 0.5 * torch.sum(p["d"] ** 2)
             - 0.5 * torch.sum(p["log_rchol"] ** 2))
    lik = emission_log_lik(p, y, x[1:])
    return (-prior - lik + dyn + trace + half_logdet + quad) / n


def gradient(p: Leaves, y, control) -> Tuple[torch.Tensor, Leaves]:
    """(nll, the sanitised gradient of every trained leaf)."""
    with torch.enable_grad():
        req = {k: v.detach().requires_grad_(k in TRAINED)
               for k, v in p.items()}
        nll = negative_elbo(req, y, control)
        grads = torch.autograd.grad(nll, [req[k] for k in TRAINED])
    clean = {k: torch.clamp(torch.nan_to_num(g, nan=0.0, posinf=0.0,
                                             neginf=0.0), -GRAD_CLIP, GRAD_CLIP)
             for k, g in zip(TRAINED, grads)}
    return nll.detach(), clean


def train_steps(p: Leaves, y, control, steps: int, grad_steps: int = 1,
                snap: int = 0):
    """``steps`` Adam iterations from ``p``.  Returns (the nll before each,
    the gradients of the first ``grad_steps``, the leaves after step
    ``snap`` (after the last if 0), the leaves after the last)."""
    p = {k: v.detach().clone() for k, v in p.items()}
    m = {k: torch.zeros_like(p[k]) for k in TRAINED}
    s = {k: torch.zeros_like(p[k]) for k in TRAINED}
    nlls, grads, at_snap = [], [], None
    for t in range(1, steps + 1):
        nll, g = gradient(p, y, control)
        nlls.append(nll)
        if t <= grad_steps:
            grads.append(g)
        c1 = 1.0 - ADAM["b1"] ** t
        c2 = 1.0 - ADAM["b2"] ** t
        for k in TRAINED:
            m[k] = ADAM["b1"] * m[k] + (1.0 - ADAM["b1"]) * g[k]
            s[k] = ADAM["b2"] * s[k] + (1.0 - ADAM["b2"]) * g[k] * g[k]
            p[k] = p[k] - (ADAM["lr"] / c1) * m[k] / (
                torch.sqrt(s[k]) / math.sqrt(c2) + ADAM["eps"])
        if t == snap:
            at_snap = dict(p)
    return torch.stack(nlls), grads, at_snap or p, p


# ---------------------------------------------------------------------------
# Evaluation: q(U), the rollout, its moments
# ---------------------------------------------------------------------------

def rollout_inputs(p: Leaves, control: torch.Tensor, n: int) -> dict:
    """Lm⁻¹ (D, M, M) and the collapsed q(U) of the trajectory x[:n+1]: its
    mean (M, D) and the upper factor chol(H)⁻ᵀ (D, M, M) of H⁻¹."""
    x = p["x"][:n + 1]
    lv, ls, z = p["kernel.log_variance"], p["kernel.log_lengthscales"], p["z"]
    eye = torch.eye(z.shape[0], dtype=z.dtype, device=z.device)
    lm_inv = tri_inv(cholesky(se_kernel(lv, ls, z, z) + JITTER * eye))
    a = lm_inv @ se_kernel(lv, ls, z, gp_inputs(x, control))
    h, avec = collapse(a, x[1:] - x[:-1], torch.exp(p["log_q"]))
    h_inv_l = tri_inv(cholesky(h))
    v = (h_inv_l @ avec[..., None])[..., 0]
    u_mean = (h_inv_l.mT @ v[..., None])[..., 0]
    return {"lm_inv": lm_inv, "u": u_mean.T, "q_sqrt": h_inv_l.mT,
            "x0": x[-1]}


def rollout(sets: List[Leaves], inputs: List[dict], controls: torch.Tensor,
            noise: torch.Tensor):
    """Free-running rollouts of G parameter sets, R rows each: noise (G, R,
    T, D).  Returns (x, σ² + Q clamped at 0), each (G, R, T, D)."""
    st = lambda f: torch.stack([f(p, i) for p, i in zip(sets, inputs)])
    lv = st(lambda p, i: p["kernel.log_variance"])            # (G, D)
    ls = st(lambda p, i: p["kernel.log_lengthscales"])        # (G, D, Din)
    z = st(lambda p, i: p["z"])                               # (G, M, Din)
    q = st(lambda p, i: torch.exp(p["log_q"]))                # (G, D)
    lm_inv = st(lambda p, i: i["lm_inv"])                     # (G, D, M, M)
    q_sqrt = st(lambda p, i: i["q_sqrt"])
    u = st(lambda p, i: i["u"]).mT                            # (G, D, M)
    x = st(lambda p, i: i["x0"])[:, None, :].expand(noise.shape[:2]
                                                    + noise.shape[3:])
    var = torch.exp(lv)
    ell = torch.exp(ls)
    xs, vs = [], []
    for t in range(noise.shape[2]):
        xc = torch.cat([x, controls[t].expand(x.shape[:2] + (-1,))], dim=-1)
        diff = ((xc[:, :, None, None, :] - z[:, None, None, :, :])
                / ell[:, None, :, None, :])                   # (G,R,D,M,Din)
        k = var[:, None, :, None] * torch.exp(-0.5 * torch.sum(diff * diff,
                                                              dim=-1))
        a = torch.einsum("gdmj,grdj->grdm", lm_inv, k)
        w = torch.einsum("gdjm,grdj->grdm", q_sqrt, a)        # q_sqrtᵀ a
        mean = torch.einsum("grdm,gdm->grd", a, u)
        v = (var[:, None, :] - torch.sum(a * a, dim=-1)
             + torch.sum(w * w, dim=-1))
        v = torch.clamp(v + q[:, None, :], min=0.0)
        x = x + mean + noise[:, :, t] * torch.sqrt(v)
        xs.append(x)
        vs.append(v)
    return torch.stack(xs, dim=2), torch.stack(vs, dim=2)


def emission_moments(p: Leaves, xs: torch.Tensor, vs: torch.Tensor):
    """Per-sample emission means x C + d and variances σ²C², and the
    emission noise variance diag(R)."""
    c, lr = p["c"], p["log_rchol"]
    chol = torch.tril(lr, -1) + torch.diag(torch.exp(torch.diagonal(lr)))
    r2 = torch.sum(chol * chol, dim=1)
    return xs @ c + p["d"], vs @ (c * c), r2


def scores(y_test: torch.Tensor, y_s, v_s, r2, y_std: float,
           horizon: int = HORIZON):
    """RMSE (de-normalised) and mean NLL of the first ``horizon`` test
    steps under the samples' pooled mean and mean variance plus diag(R)."""
    py = torch.mean(y_s, dim=0)[:horizon].reshape(-1)
    pv = (torch.mean(v_s, dim=0) + r2)[:horizon].reshape(-1)
    yt = y_test[:horizon].reshape(-1)
    rmse = torch.sqrt(torch.mean((yt - py) ** 2)) * y_std
    nll = -torch.mean(-0.5 * torch.log(2 * math.pi * pv)
                      - 0.5 * (yt - py) ** 2 / pv)
    return float(rmse), float(nll)


# ---------------------------------------------------------------------------
# The rollout's random numbers
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_PM = (0xD2511F53, 0xCD9E8D57)
_PW = (0x9E3779B9, 0xBB67AE85)


def _mul32(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of a·b, a a 32-bit constant and b int64
    tensors of 32-bit values, in 16-bit halves so nothing overflows."""
    lo16, hi16 = a * (b & 0xFFFF), a * (b >> 16)
    low = (lo16 + ((hi16 & 0xFFFF) << 16)) & _M32
    high = (hi16 + (lo16 >> 16)) >> 16
    return high, low


def philox_normals(key: int, shape: Sequence[int], dtype, device,
                   row_offset: int = 0) -> torch.Tensor:
    """(rows, T, D) normals: Philox4x32-10 (Salmon et al., SC'11) of the
    counter (row_offset + row, t, d, 0) under the 64-bit ``key``, and
    Box-Muller on its first two words: u1 = ((w0 >> 8) + 1)·2⁻²⁴,
    u2 = (w1 >> 8)·2⁻²⁴, √(−2 ln u1)·cos(2π u2)."""
    idx = [torch.arange(n, dtype=torch.int64, device=device) for n in shape]
    c = [(idx[0] + row_offset)[:, None, None].expand(*shape),
         idx[1][None, :, None].expand(*shape),
         idx[2][None, None, :].expand(*shape)]
    c.append(torch.zeros_like(c[0]))
    k0, k1 = key & _M32, (key >> 32) & _M32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PW[0]) & _M32, (k1 + _PW[1]) & _M32
        h0, l0 = _mul32(_PM[0], c[0])
        h1, l1 = _mul32(_PM[1], c[2])
        c = [h1 ^ c[1] ^ k0, l1, h0 ^ c[3] ^ k1, l0]
    u1 = ((c[0] >> 8) + 1).to(dtype) * 2.0 ** -24
    u2 = (c[1] >> 8).to(dtype) * 2.0 ** -24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


def keys_of(seed: int, n: int = 1) -> List[int]:
    """The first ``n`` 63-bit keys (``randint`` below 2⁶³ − 1) of a CPU
    ``torch.Generator`` seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return [int(torch.randint(0, 2 ** 63 - 1, (), generator=g,
                              dtype=torch.int64)) for _ in range(n)]
