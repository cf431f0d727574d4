"""The sampling tools of the PyTorch port against the JAX package's.

The flow of ``tests/test_satellites.py:test_sampling_tools_golden`` (the
reference's sampling_test example) through both packages with the same
``np.random.seed(123)``: the plans, the sample files and the data handler's
results, filters included, are equal exactly.  ``Sampler.sample_batched``
with its default vmap (``jax.vmap`` against ``torch.func.vmap``) agrees to
1e-12 and writes the same sample files; files that exist are skipped.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import dompc_tpu as jdm
import dompc_tpu_torch as tdm


@pytest.fixture(scope="module", autouse=True)
def _cpu_port():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOMPC_TPU_PLATFORM", "cpu")
        mp.setenv("DOMPC_TPU_X64", "1")
        yield
    torch.set_num_threads(threads)


def _plan(dm, data_dir):
    """tests/test_satellites.py:16-26 for either package."""
    np.random.seed(123)
    sp = dm.sampling.SamplingPlanner()
    sp.set_param(overwrite=True)
    sp.data_dir = data_dir
    sp.set_sampling_var("alpha", lambda: np.random.randn())
    sp.set_sampling_var("beta", lambda: np.random.randint(0, 5))
    sp.gen_sampling_plan(n_samples=10)
    sp.add_sampling_case(alpha=10)
    sp.add_sampling_case(beta=10)
    plan = sp.add_sampling_case(alpha=2, beta=2)
    sp.export("plan")
    return plan


def _flow(dm, data_dir):
    """tests/test_satellites.py:16-40: plan, sequential sampling, data
    handler with two post-processing functions, two filters."""
    plan = _plan(dm, data_dir)
    sampler = dm.sampling.Sampler(plan)
    sampler.set_param(overwrite=True, print_progress=False)
    sampler.data_dir = data_dir
    sampler.set_sample_function(lambda alpha, beta: alpha * beta)
    sampler.sample_data()
    dh = dm.sampling.DataHandler(plan)
    dh.data_dir = data_dir
    dh.set_post_processing("res_1", lambda x: x)
    dh.set_post_processing("res_2", lambda x: x ** 2)
    return dict(plan=plan, res=dh[:], res_last=dh[-1], res_0=dh[0],
                res1=dh.filter(input_filter=lambda alpha: alpha < 0),
                res2=dh.filter(output_filter=lambda res_1: res_1 < 0))


def _files(data_dir):
    out = {}
    for name in sorted(os.listdir(data_dir)):
        with open(os.path.join(data_dir, name), "rb") as f:
            out[name] = pickle.load(f)
    return out


def test_sampling_flow_matches_jax(tmp_path):
    jdir, tdir = str(tmp_path / "jax") + "/", str(tmp_path / "port") + "/"
    j, t = _flow(jdm, jdir), _flow(tdm, tdir)
    assert len(j["plan"]) == 13
    for key in ("plan", "res", "res_last", "res_0", "res1", "res2"):
        assert t[key] == j[key], key
    assert t["res1"] and t["res2"]
    assert _files(tdir) == _files(jdir)
    assert tdm.tools.load_pickle(tdir + "plan") == j["plan"]
    # the planner refuses to overwrite an exported plan unless asked
    sp = tdm.sampling.SamplingPlanner()
    sp.data_dir = tdir
    with pytest.raises(FileExistsError):
        sp.export("plan")


def test_product_plan_matches_jax():
    plans = []
    for dm in (jdm, tdm):
        sp = dm.sampling.SamplingPlanner()
        sp.set_sampling_var("a")
        sp.set_sampling_var("b")
        plans.append(sp.product(a=[1, 2, 3], b=[0.5, -1.0]))
    assert plans[1] == plans[0] and len(plans[0]) == 6


def _batched(dm, data_dir):
    plan = _plan(dm, data_dir)
    sampler = dm.sampling.Sampler(plan)
    sampler.set_param(overwrite=True, print_progress=False)
    sampler.data_dir = data_dir
    sampler.set_sample_function(
        lambda alpha, beta: {"prod": alpha * beta,
                             "smooth": alpha ** 3 - 0.5 * beta})
    return plan, sampler, sampler.sample_batched()


def test_sample_batched_matches_jax(tmp_path):
    """The default vmap over the stacked plan: results to 1e-12 (float64),
    the same per-sample files, and resumability: sample_data skips every
    file sample_batched wrote."""
    jdir, tdir = str(tmp_path / "jax") + "/", str(tmp_path / "port") + "/"
    _, _, j = _batched(jdm, jdir)
    plan, sampler, t = _batched(tdm, tdir)
    assert set(t) == set(j)
    for key in j:
        assert t[key].shape == (len(plan),)
        np.testing.assert_allclose(t[key], np.asarray(j[key]), rtol=1e-12,
                                   atol=1e-12)
    jf, tf = _files(jdir), _files(tdir)
    assert set(tf) == set(jf)
    for name in jf:
        if name == "plan.pkl":
            assert tf[name] == jf[name]
            continue
        for key in jf[name]:
            np.testing.assert_allclose(tf[name][key], jf[name][key],
                                       rtol=1e-12, atol=1e-12)
    calls = []
    sampler.set_param(overwrite=False)
    sampler.set_sample_function(lambda alpha, beta: calls.append(1))
    sampler.sample_data()
    assert calls == []
    # a removed file is sampled again, the others are kept
    removed = f"sample_{plan[3]['id']}.pkl"
    os.remove(os.path.join(tdir, removed))
    sampler.set_sample_function(lambda alpha, beta: alpha * beta)
    sampler.sample_data()
    after = _files(tdir)
    assert after.pop(removed) == plan[3]["alpha"] * plan[3]["beta"]
    tf.pop(removed)
    assert after == tf
