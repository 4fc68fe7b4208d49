"""Configuration: the case table, the experiment config and the
trainability partition.

A copy of ``ffvd_tpu/config.py`` (the port imports nothing of the JAX
package).  The field set, defaults and validation are the same, so a config
built for one package means the same run in the other; the long rationale
for each SGHMC/PG/ds64 field lives in the JAX module.  ``collapse_precision``
"ds64" is a float64 segment in the port (``model/ds_collapse.py``), so
``ds64_refine`` is validated and has no effect.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

PRIOR_TYPES = ("uniform", "normal", "determinantal", "strauss")
KERNEL_TYPES = ("SquaredExponential", "LinearK")

DATASETS = ("dryer", "drive", "gas_furnace", "actuator", "flutter", "ballbeam")
# Index order of the reference's --file_index flag (FFVD_Main.py:383).
FILE_INDEX_ORDER = DATASETS

# Datasets where the JAX package's deep-transition study measured a win for
# n_layers=2 (PARITY §2b-deep).
DEEP_UNDERFIT_DATASETS = ("flutter", "drive")


@dataclasses.dataclass(frozen=True)
class CaseConfig:
    """One row of the reference's case table (FFVD_Main.py:273-324).

    ``kernel_optimization`` / ``u_optimization`` / ``z_optimization`` mean
    "this block is Adam-trainable"; when False (and not collapsed) the block
    is sampled by SG-HMC instead (dgp_model.py:213-243).
    """

    name: str
    kernel_optimization: bool
    u_optimization: bool
    z_optimization: bool
    u_collapse: bool
    x_pg: bool


CASE_TABLE = {
    1: CaseConfig("C1", True, True, True, False, False),
    2: CaseConfig("C2", False, False, True, False, False),
    3: CaseConfig("C3", False, False, False, False, False),
    4: CaseConfig("C4", True, False, True, True, False),
    5: CaseConfig("C5", False, False, True, True, False),
    6: CaseConfig("C6", True, True, True, False, True),
    # C7 is only reachable programmatically in the reference
    # (dgp_model.py:62,181,215-218): X and U sampled, everything else frozen.
    7: CaseConfig("C7", False, False, False, False, False),
}


@dataclasses.dataclass(frozen=True)
class FFVDConfig:
    """Full experiment configuration (reference: argparse FFVD_Main.py:355-379
    merged with ARGS mutations FFVD_Main.py:236-340)."""

    dataset: str = "ballbeam"
    case: int = 4
    num_inducing: int = 100
    x_dim: int = 4
    iterations: int = 2000          # outer loop runs 2 * iterations (models.py:142)
    window_size: int = 64
    num_posterior_samples: int = 10
    posterior_sample_spacing: int = 32
    prior_type: str = "normal"      # CLI default (FFVD_Main.py:378)
    kernel_type: str = "SquaredExponential"
    kernel_train_flag: bool = True
    likelihood_training: bool = True
    hyperparameter_sampling: bool = False
    epsilon: float = 0.01           # SGHMC step size (FFVD_Main.py:343)
    mdecay: float = 0.05            # SGHMC momentum decay (dgp_model.py:161)
    adam_lr: float = 0.003          # base lr; effective lr = 0.003*0.95^(1/1000)
    pg_particles: int = 100         # CSMC pool size (base_model.py:78)
    jitter: float = 1e-5            # Kmm jitter (conditionals_multi_output.py:108)
    # fp32 guards of the SG-HMC sampler; the Adam path uses only the
    # gradient clip (inference/trainer.py).
    sghmc_log_clip: Optional[float] = 12.0
    sghmc_log_clip_lower: Optional[float] = -30.0
    sghmc_grad_clip: Optional[float] = 1e6
    sghmc_spike_clip: Optional[float] = 20.0
    sghmc_p_clip: Optional[float] = 1.0
    prng_impl: str = "threefry2x32"
    sghmc_unroll: int = 1
    pg_ancestor_trace: Optional[bool] = None
    pg_compat_noop: bool = False
    minibatch_size: Optional[int] = None
    # Bug-compat with the reference's rollout q_sqrt indexing slip
    # (conditionals_multi_output.py:322): dim 0's q(U) factor applied to
    # every dim's predictive variance.
    rollout_qsqrt_dim0: bool = False
    emission_noise: str = "auto"
    n_layers: int = 1
    deep_sample_hidden: bool = False
    deep_hidden_init_scale: float = 1.0
    collapse_precision: str = "native"
    ds64_refine: Optional[int] = None
    hybrid_tail_iters: int = 500
    file_id: int = 3                # warm-start file selector (FFVD_Main.py:363)
    seed: int = 0

    def __post_init__(self):
        if self.prior_type not in PRIOR_TYPES:
            raise ValueError(f"invalid prior_type {self.prior_type!r}")
        if self.kernel_type not in KERNEL_TYPES:
            raise ValueError(f"invalid kernel_type {self.kernel_type!r}")
        if self.case not in CASE_TABLE:
            raise ValueError(f"invalid case {self.case}")
        if self.emission_noise not in ("auto", "diag", "full"):
            raise ValueError(f"invalid emission_noise {self.emission_noise!r}")
        if self.collapse_precision not in ("native", "ds64", "hybrid"):
            raise ValueError(
                f"invalid collapse_precision {self.collapse_precision!r}")
        if self.ds64_refine is not None and self.ds64_refine < 0:
            raise ValueError("ds64_refine must be >= 0 or None")
        if self.hybrid_tail_iters < 0:
            raise ValueError("hybrid_tail_iters must be >= 0")
        if self.minibatch_size is not None and self.minibatch_size < 1:
            raise ValueError("minibatch_size must be >= 1 or None")
        if self.n_layers < 1:
            raise ValueError("n_layers must be >= 1")
        if (self.sghmc_log_clip is not None
                and self.sghmc_log_clip_lower is not None
                and self.sghmc_log_clip_lower >= self.sghmc_log_clip):
            raise ValueError(
                "sghmc_log_clip_lower must be < sghmc_log_clip "
                f"({self.sghmc_log_clip_lower} >= {self.sghmc_log_clip})")
        if self.pg_ancestor_trace is None:
            object.__setattr__(self, "pg_ancestor_trace",
                               not self.pg_compat_noop)
        elif self.pg_compat_noop and self.pg_ancestor_trace:
            raise ValueError(
                "pg_compat_noop and pg_ancestor_trace are mutually exclusive: "
                "compat-noop makes the PG update an identity (the reference's "
                "dead assign), so an ancestor-traced CSMC would silently "
                "never run")

    @property
    def log_clip_bounds(self) -> Optional[tuple]:
        """(lower, upper) bounds for SGHMC-sampled log-parameters, or None
        when clipping is disabled; a None lower mirrors the upper bound."""
        if self.sghmc_log_clip is None:
            return None
        lo = (-self.sghmc_log_clip if self.sghmc_log_clip_lower is None
              else self.sghmc_log_clip_lower)
        return (lo, self.sghmc_log_clip)

    @property
    def case_config(self) -> CaseConfig:
        return CASE_TABLE[self.case]

    @property
    def total_iterations(self) -> int:
        """The reference loop runs 2×iterations actual steps (models.py:142)."""
        return 2 * self.iterations


# ---------------------------------------------------------------------------
# Trainability partition
# ---------------------------------------------------------------------------

ADAM, SGHMC, FROZEN = "adam", "sghmc", "frozen"


@dataclasses.dataclass(frozen=True)
class Partition:
    """Label per parameter block: 'adam' | 'sghmc' | 'frozen'.

    Semantics follow dgp_model.py:213-243 + Layer.__init__ (dgp_model.py:45-94)
    + kernels_multi_output.py:156-161 + likelihoods.py:12-61.
    """

    x: str
    u: str
    z: str
    kernel: str
    log_q: str
    lik: str  # C, d, log_Rchol together


def partition_for(cfg: FFVDConfig) -> Partition:
    cc = cfg.case_config
    if cfg.case == 7:
        return Partition(x=SGHMC, u=SGHMC, z=FROZEN, kernel=FROZEN,
                         log_q=FROZEN, lik=FROZEN)

    x = FROZEN if cc.x_pg else ADAM
    u = FROZEN if cc.u_collapse else (ADAM if cc.u_optimization else SGHMC)
    z = ADAM if cc.z_optimization else SGHMC
    if cc.kernel_optimization:
        kernel = ADAM
    else:
        kernel = SGHMC if cfg.kernel_train_flag else FROZEN
    if cfg.hyperparameter_sampling:
        log_q = SGHMC
        lik = SGHMC
    else:
        log_q = ADAM
        lik = ADAM if cfg.likelihood_training else FROZEN
    return Partition(x=x, u=u, z=z, kernel=kernel, log_q=log_q, lik=lik)
