"""Problem serialization (a copy of ``piqp_tpu/utils/io.py``).

Analog of the reference's io_utils (save/load dense & sparse Model as
MATLAB .mat via matio, utils/io_utils.hpp:22-96).

- :func:`load_mat` reads the reference's .mat problem files (including the
  Maros-Meszaros / Netlib corpus fixtures) via scipy.
- :func:`save_npz` / :func:`load_npz` are the native round-trip format.
"""

from __future__ import annotations

import numpy as np


def _vec(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float64).ravel()


def load_mat(path: str, sparse: bool = False) -> dict:
    """Load a QP stored by piqp::save_dense_model/save_sparse_model.

    Returns a dict with P, c, A, b, G, h_l, h_u, x_l, x_u.  Matrices are
    scipy.sparse CSC when ``sparse`` else dense ndarrays.  matio stores
    integer-valued vectors with compressed dtypes; we upcast to float64.
    """
    import scipy.io as sio
    import scipy.sparse as sp

    d = sio.loadmat(path)

    def mat(key):
        M = d[key]
        if sp.issparse(M):
            return M.tocsc().astype(np.float64) if sparse else np.asarray(
                M.todense(), dtype=np.float64
            )
        M = np.asarray(M, dtype=np.float64)
        return sp.csc_matrix(M) if sparse else M

    out = dict(
        P=mat("P"),
        c=_vec(d["c"]),
        A=mat("A"),
        b=_vec(d["b"]),
        G=mat("G"),
        h_l=_vec(d["h_l"]) if "h_l" in d else None,
        h_u=_vec(d["h_u"]) if "h_u" in d else None,
        x_l=_vec(d["x_l"]) if "x_l" in d else None,
        x_u=_vec(d["x_u"]) if "x_u" in d else None,
    )
    if out["A"].shape[0] == 0:
        out["A"], out["b"] = None, None
    if out["G"].shape[0] == 0:
        out["G"], out["h_l"], out["h_u"] = None, None, None
    return out


def save_mat(path: str, prob: dict, sparse: bool = True) -> None:
    """Save a problem dict to a .mat file readable by the reference's
    piqp::load_dense_model/load_sparse_model (io_utils.hpp:58-96)."""
    import scipy.io as sio
    import scipy.sparse as sp

    n = np.asarray(prob["P"]).shape[0] if not sp.issparse(prob["P"]) else prob["P"].shape[0]

    def mat(M, rows):
        if M is None:
            M = np.zeros((rows, n))
        return sp.csc_matrix(M) if sparse else np.asarray(M, dtype=np.float64)

    m = 0 if prob.get("G") is None else (
        prob["G"].shape[0] if hasattr(prob["G"], "shape") else np.asarray(prob["G"]).shape[0]
    )
    p = 0 if prob.get("A") is None else (
        prob["A"].shape[0] if hasattr(prob["A"], "shape") else np.asarray(prob["A"]).shape[0]
    )
    out = {
        "P": mat(prob["P"], n),
        "c": _vec(prob["c"]).reshape(-1, 1),
        "A": mat(prob.get("A"), 0 if prob.get("A") is None else p),
        "b": _vec(prob.get("b") if prob.get("b") is not None else np.zeros(p)).reshape(-1, 1),
        "G": mat(prob.get("G"), 0 if prob.get("G") is None else m),
        "h_l": _vec(
            prob.get("h_l") if prob.get("h_l") is not None else np.full(m, -np.inf)
        ).reshape(-1, 1),
        "h_u": _vec(
            prob.get("h_u") if prob.get("h_u") is not None else np.full(m, np.inf)
        ).reshape(-1, 1),
        "x_l": _vec(
            prob.get("x_l") if prob.get("x_l") is not None else np.full(n, -np.inf)
        ).reshape(-1, 1),
        "x_u": _vec(
            prob.get("x_u") if prob.get("x_u") is not None else np.full(n, np.inf)
        ).reshape(-1, 1),
    }
    sio.savemat(path, out)


def save_npz(path: str, prob: dict) -> None:
    """Save a problem dict (dense or scipy.sparse matrices) to npz."""
    import scipy.sparse as sp

    arrays = {}
    for k, v in prob.items():
        if v is None:
            continue
        if sp.issparse(v):
            v = v.tocsc()
            arrays[f"{k}__data"] = v.data
            arrays[f"{k}__indices"] = v.indices
            arrays[f"{k}__indptr"] = v.indptr
            arrays[f"{k}__shape"] = np.asarray(v.shape)
        else:
            arrays[k] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_npz(path: str) -> dict:
    import scipy.sparse as sp

    with np.load(path) as f:
        keys = set(f.files)
        out = {}
        sparse_roots = {k.split("__")[0] for k in keys if "__" in k}
        for root in sparse_roots:
            out[root] = sp.csc_matrix(
                (
                    f[f"{root}__data"],
                    f[f"{root}__indices"],
                    f[f"{root}__indptr"],
                ),
                shape=tuple(f[f"{root}__shape"]),
            )
        for k in keys:
            if "__" not in k:
                out[k] = f[k]
    return out
