"""Port parity (a): configuration, data and warm starts equal the JAX
package's exactly.

The port keeps its own copies of ``config.py``, ``data/loaders.py`` and
``data/warmstart.py``; these tests hold each against the JAX module on the
same inputs (all six datasets, cases 1-7).  Every comparison is exact:
both sides do the same numpy float64 arithmetic on the same files.
"""

import dataclasses

import numpy as np
import pytest
import torch

import ffvd_tpu.config as jcfg
from ffvd_tpu.data import create_dataset as j_create_dataset
from ffvd_tpu.data import load_warmstart as j_load_warmstart
from ffvd_tpu.model.params import init_params_from_warmstart as j_init

import ffvd_tpu_torch.config as tcfg
from ffvd_tpu_torch.data import create_dataset, load_warmstart
from ffvd_tpu_torch.model.params import (LEAF_PATHS, init_params_from_warmstart,
                                         params_from_numpy, params_to_numpy)

torch.set_num_threads(1)

DATASETS = ("dryer", "drive", "gas_furnace", "actuator", "flutter", "ballbeam")


def jax_leaves(p):
    """The JAX GPSSMParams leaves keyed by the port's field paths."""
    return {"x": p.x, "u": p.u, "z": p.z,
            "kernel.log_variance": p.kernel.log_variance,
            "kernel.log_lengthscales": p.kernel.log_lengthscales,
            "log_q": p.log_q, "c": p.c, "d": p.d, "log_rchol": p.log_rchol}


def test_case_table_equal():
    assert set(tcfg.CASE_TABLE) == set(jcfg.CASE_TABLE)
    for k, row in jcfg.CASE_TABLE.items():
        assert dataclasses.asdict(tcfg.CASE_TABLE[k]) == dataclasses.asdict(row)
    assert tcfg.DATASETS == jcfg.DATASETS
    assert tcfg.FILE_INDEX_ORDER == jcfg.FILE_INDEX_ORDER


def test_config_fields_and_defaults_equal():
    j = dataclasses.asdict(jcfg.FFVDConfig())
    t = dataclasses.asdict(tcfg.FFVDConfig())
    assert t == j


@pytest.mark.parametrize("case", range(1, 8))
@pytest.mark.parametrize("variant", [
    {}, {"hyperparameter_sampling": True}, {"likelihood_training": False},
    {"kernel_train_flag": False}])
def test_partition_for_equal(case, variant):
    j = jcfg.partition_for(jcfg.FFVDConfig(case=case, **variant))
    t = tcfg.partition_for(tcfg.FFVDConfig(case=case, **variant))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    cfg = tcfg.FFVDConfig(case=case, **variant)
    jc = jcfg.FFVDConfig(case=case, **variant)
    assert cfg.total_iterations == jc.total_iterations
    assert cfg.log_clip_bounds == jc.log_clip_bounds
    assert cfg.pg_ancestor_trace == jc.pg_ancestor_trace


@pytest.mark.parametrize("bad", [
    {"prior_type": "gamma"}, {"kernel_type": "Matern"}, {"case": 8},
    {"emission_noise": "x"}, {"collapse_precision": "fp16"},
    {"ds64_refine": -1}, {"hybrid_tail_iters": -1}, {"minibatch_size": 0},
    {"n_layers": 0}, {"sghmc_log_clip": 1.0, "sghmc_log_clip_lower": 2.0},
    {"pg_compat_noop": True, "pg_ancestor_trace": True}])
def test_config_validation_equal(bad):
    with pytest.raises(ValueError):
        jcfg.FFVDConfig(**bad)
    with pytest.raises(ValueError):
        tcfg.FFVDConfig(**bad)


@pytest.mark.parametrize("name", DATASETS)
def test_create_dataset_equal(name):
    j = j_create_dataset(name)
    t = create_dataset(name)
    for f in ("y_train", "y_test", "control"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    for f in ("y_train_std", "y_train_mean", "control_mean", "control_std"):
        assert getattr(t, f) == getattr(j, f)


@pytest.mark.parametrize("name", DATASETS)
def test_warmstart_params_equal(name):
    ws_j = j_load_warmstart(name)
    ws_t = load_warmstart(name)
    assert sorted(ws_t) == sorted(ws_j)
    jp = jax_leaves(j_init(ws_j))
    tp = params_to_numpy(init_params_from_warmstart(ws_t))
    assert tuple(tp) == LEAF_PATHS
    for k in LEAF_PATHS:
        np.testing.assert_array_equal(tp[k], np.asarray(jp[k]), err_msg=k)


def test_params_numpy_roundtrip():
    jp = {k: np.asarray(v) for k, v in
          jax_leaves(j_init(j_load_warmstart("ballbeam"))).items()}
    p = params_from_numpy(jp)
    assert p.x.dtype == torch.float64 and p.n_transitions == 500
    assert p.x_dim == 4 and p.p_dim == 1
    back = params_to_numpy(p)
    for k in LEAF_PATHS:
        np.testing.assert_array_equal(back[k], jp[k])
    with pytest.raises(KeyError):
        params_from_numpy({k: v for k, v in jp.items() if k != "z"})


def test_unknown_dataset_and_missing_warmstart():
    with pytest.raises(ValueError):
        create_dataset("nope")
    with pytest.raises(FileNotFoundError):
        load_warmstart("ballbeam", file_id=0)   # only file_id=3 is vendored
