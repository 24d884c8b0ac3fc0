"""The port's copies of the JAX package's utils against the originals on the
same inputs: ``utils/pad.py`` (``next_bucket``, ``pad_problem``,
``unpad_result``) and ``utils/io.py`` (``save_mat``/``load_mat`` on a file
this test writes, ``save_npz``/``load_npz``), exactly equal; and
``utils/profiling.py``: ``trace`` writes a Chrome trace under tmp_path that
names the ``annotate`` ranges of a sharded solve on the CPU."""

import json

import numpy as np
import pytest
import scipy.sparse as sp

from piqp_tpu.utils import io as jio
from piqp_tpu.utils import pad as jpad

import piqp_tpu_torch
from piqp_tpu_torch import solve_dense, solve_horizon_sharded
from piqp_tpu_torch import multistage as tms
from piqp_tpu_torch.parallel import sharded_calls
from piqp_tpu_torch.utils import io as tio
from piqp_tpu_torch.utils import pad as tpad
from piqp_tpu_torch.utils import profiling
from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

from test_torch_horizon_ranks import gloo  # noqa: F401  (fixture)

KEYS = ("P", "c", "A", "b", "G", "h_l", "h_u", "x_l", "x_u")


def _problem(seed, bounds=True):
    prob = dense_strongly_convex_qp(6, 2, 3, seed=seed)
    if not bounds:
        prob = dict(prob, x_l=None, x_u=None)
    return prob


def _assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
            continue
        g, w = got[k], want[k]
        if sp.issparse(w):
            assert sp.issparse(g), k
            g, w = g.toarray(), w.toarray()
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=k)


def test_next_bucket_matches_jax():
    for x in range(0, 70):
        for minimum in (0, 1, 8):
            assert tpad.next_bucket(x, minimum) == jpad.next_bucket(x, minimum)


@pytest.mark.parametrize("kw", [dict(bucket=True), dict(n_to=9, p_to=4, m_to=5),
                                dict(n_to=6)], ids=["bucket", "explicit", "n-only"])
@pytest.mark.parametrize("bounds", [True, False])
def test_pad_problem_matches_jax(kw, bounds):
    prob = _problem(3, bounds)
    got, dims = tpad.pad_problem(prob, **kw)
    want, jdims = jpad.pad_problem(prob, **kw)
    assert dims == jdims
    _assert_dicts_equal(got, want)


def test_pad_problem_refuses_to_shrink():
    with pytest.raises(ValueError, match="cannot pad"):
        tpad.pad_problem(_problem(3), n_to=4)


def test_unpad_result_matches_jax_and_solves_the_original():
    prob = _problem(4)
    padded, dims = tpad.pad_problem(prob, bucket=True)
    res = solve_dense(**padded, device="cpu")
    got = tpad.unpad_result(res, dims)
    want = jpad.unpad_result(res, dims)  # numpy views of the same tensors
    for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu", "s_l", "s_u", "s_bl", "s_bu"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(want, k), err_msg=k)
    assert got.info is res.info
    direct = solve_dense(**prob, device="cpu")
    assert int(direct.info.status) == int(res.info.status) == int(piqp_tpu_torch.Status.SOLVED)
    np.testing.assert_allclose(got.x.numpy(), direct.x.numpy(), atol=1e-6)


@pytest.mark.parametrize("sparse", [True, False])
def test_mat_round_trip_matches_jax(sparse, tmp_path):
    prob = _problem(5)
    tio.save_mat(str(tmp_path / "port.mat"), prob, sparse=sparse)
    jio.save_mat(str(tmp_path / "jax.mat"), prob, sparse=sparse)
    for path in ("port.mat", "jax.mat"):
        for as_sparse in (False, True):
            got = tio.load_mat(str(tmp_path / path), sparse=as_sparse)
            want = jio.load_mat(str(tmp_path / path), sparse=as_sparse)
            _assert_dicts_equal(got, want)
    back = tio.load_mat(str(tmp_path / "port.mat"))
    for k in KEYS:
        np.testing.assert_array_equal(back[k], np.asarray(prob[k], dtype=np.float64), err_msg=k)


def test_npz_round_trip_matches_jax(tmp_path):
    prob = _problem(6)
    prob = dict(prob, A=sp.csc_matrix(prob["A"]), G=None, h_l=None, h_u=None)
    tio.save_npz(str(tmp_path / "port.npz"), prob)
    jio.save_npz(str(tmp_path / "jax.npz"), prob)
    for path in ("port.npz", "jax.npz"):
        got = tio.load_npz(str(tmp_path / path))
        _assert_dicts_equal(got, jio.load_npz(str(tmp_path / path)))
    got = tio.load_npz(str(tmp_path / "port.npz"))
    assert sp.issparse(got["A"]) and "G" not in got
    np.testing.assert_array_equal(got["A"].toarray(), prob["A"].toarray())


def test_trace_names_the_sharded_ranges(tmp_path, gloo):  # noqa: F811
    data = tms.random_multistage_qp(T=8, D=3, Da=2, ra=2, rg=2, seed=0, device="cpu")
    before = dict(sharded_calls)
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("user.region"):
            res = solve_horizon_sharded(data, chunks=2)
    assert res.info.status.tolist() == [int(piqp_tpu_torch.Status.SOLVED)]
    path = tmp_path / "prof" / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"user.region", "piqp.horizon.factor", "piqp.horizon.solve"} <= names
    # one range per sharded factor and solve the solve ran
    for what in ("factor", "solve"):
        ranges = sum(e.get("name") == f"piqp.horizon.{what}" for e in events)
        assert ranges == sharded_calls[what] - before[what] > 0, what
