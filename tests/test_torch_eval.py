"""Port parity (e), the slice end to end: ``FFVDModel(device="cpu")`` trains
ballbeam C4 and evaluates it, against the JAX ``FFVDModel`` fed the same
rollout noise (the normals JAX's ``collect_posterior`` draws, passed to the
port through ``noise=``).  fp64; RMSE/NLL within rtol 1e-6 (measured
agreement is far tighter: both packages do the same arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ffvd_tpu.api import FFVDModel as JFFVDModel
from ffvd_tpu.config import FFVDConfig as JConfig

from ffvd_tpu_torch.api import FFVDModel, RegressionModel
from ffvd_tpu_torch.cli import main as cli_main
from ffvd_tpu_torch.config import FFVDConfig

torch.set_num_threads(2)


def _jax_rollout_noise(key, num, t_len, d):
    """The normals of JAX's next ``evaluate()``: predict splits the model
    key, collect_posterior splits ``num`` sample keys, and _rollout_one
    draws normal(split(k, T)[t], (D,)) per step."""
    _, sub = jax.random.split(key)

    def per_sample(k):
        return jax.vmap(lambda kt: jax.random.normal(kt, (d,), jnp.float64))(
            jax.random.split(k, t_len))
    return np.asarray(jax.jit(jax.vmap(per_sample))(
        jax.random.split(sub, num)))


def test_fit_evaluate_save_match_jax_with_shared_noise(tmp_path):
    jm = JFFVDModel(JConfig(dataset="ballbeam", case=4))
    jm.fit(50)
    noise = _jax_rollout_noise(jm.key, 10, 500, 4)
    jres = jm.evaluate()

    tm = FFVDModel(FFVDConfig(dataset="ballbeam", case=4), device="cpu")
    assert tm.dtype == torch.float64
    tm.fit(50)
    tres = tm.evaluate(noise=torch.tensor(noise))

    np.testing.assert_allclose(tm.nll_trace.numpy(),
                               np.asarray(jm.nll_trace), rtol=1e-12)
    np.testing.assert_allclose(tres["rmse"], jres["rmse"], rtol=1e-6)
    np.testing.assert_allclose(tres["nll"], jres["nll"], rtol=1e-6)
    np.testing.assert_allclose(tres["predict_y"], jres["predict_y"],
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tres["predict_y_var"], jres["predict_y_var"],
                               rtol=1e-6)

    jpath = jm.save_results(tmp_path / "jax.npz")
    tpath = tm.save_results(tmp_path / "torch.npz")
    with np.load(jpath, allow_pickle=True) as j, \
            np.load(tpath, allow_pickle=True) as t:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            if j[k].dtype.kind == "f":
                np.testing.assert_allclose(t[k], j[k], rtol=1e-6, atol=1e-9,
                                           err_msg=k)
            elif k != "mc_posterior_samples":
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_evaluate_draws_philox_noise_reproducibly():
    cfg = FFVDConfig(dataset="ballbeam", case=4)
    a = FFVDModel(cfg, device="cpu").fit(3)
    b = FFVDModel(cfg, device="cpu").fit(3)
    ra, rb = a.evaluate_quick(), b.evaluate_quick()
    assert ra == rb and np.isfinite(ra["rmse"]) and np.isfinite(ra["nll"])
    r1 = a.evaluate()
    r2 = a.evaluate()          # the generator moved on: new draws
    assert r1["rmse"] != r2["rmse"]
    spread = a.evaluate(spread=True, num_samples=4)
    assert np.isfinite(spread["nll"])


def test_c1_evaluates_without_q_sqrt():
    m = RegressionModel("normal", device="cpu", dataset="ballbeam", case=1)
    res = m.fit(3, eval_every=3).evaluate(num_samples=2)
    assert np.isfinite(res["rmse"]) and len(m.rmse_seq) == 1


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FFVDModel(FFVDConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--file_index", "5", "--iterations", "1"])


@pytest.mark.parametrize("kw,item", [
    ({"num_inducing": 50}, "item 11"),
    ({"collapse_precision": "hybrid"}, "item 9")])
def test_unported_model_options_raise(kw, item):
    """Both options of the once-unported list now run: hybrid precision
    (item 9) and a ``num_inducing`` other than the warm start's (item 11,
    the inducing set resized by ``parallel/multidataset.py::
    _resize_inducing``)."""
    if item == "item 9":
        m = FFVDModel(FFVDConfig(**kw, hybrid_tail_iters=1), device="cpu")
        assert m.hybrid and m.eval_trainer.train_precision == "ds64"
    else:
        m = FFVDModel(FFVDConfig(**kw), device="cpu")
        assert m.params.z.shape[0] == kw["num_inducing"]
    res = m.fit(2).evaluate(num_samples=2)
    assert np.isfinite(res["rmse"]) and np.isfinite(res["nll"])


def test_cli_runs_on_cpu_and_writes_results(tmp_path, capsys):
    out = cli_main(["--file_index", "5", "--case_val", "4",
                    "--iterations", "2", "--platform", "cpu",
                    "--results_dir", str(tmp_path)])
    assert np.isfinite(out["rmse"]) and np.isfinite(out["final_elbo"])
    files = list((tmp_path / "ballbeam").glob("C4VFE_result_ballbeam_*"))
    assert len(files) == 1
    with np.load(files[0], allow_pickle=True) as z:
        assert z["ll_seq"].shape == (4,) and str(z["case"]) == "C4"
    assert "cpu fp64" in capsys.readouterr().out
    # --n_ensemble 2: two chains pooled, the same results-npz contract
    ens = cli_main(["--file_index", "5", "--case_val", "4", "--n_ensemble",
                    "2", "--iterations", "1", "--samples", "2",
                    "--eval_spread", "--platform", "cpu",
                    "--results_dir", str(tmp_path / "ens")])
    assert len(ens["per_chain"]) == 2 and np.isfinite(ens["nll"])
    files = list((tmp_path / "ens" / "ballbeam").glob("C4VFE_result_*"))
    assert len(files) == 1
    with np.load(files[0], allow_pickle=True) as z:
        assert z["ll_seq"].shape == (2,) and z["y_test_vfe"].shape == (500,)
    assert "ensemble(2) pooled" in capsys.readouterr().out
