"""A stage-structured configuration for the benchmark's own tests and its
set-up probe, built without a file under ``configs/``, ``generators/``,
``entries/``, ``modes/`` or ``metrics/``: its generator and entry are this
module, registered by name in ``byname``, and its configuration and cell
are written into a copy of ``BENCHMARK.json``.  It stands for no
deployment; it shows that a configuration whose program data is
``multistage.StageQPData`` runs through the harness by new files only.

The generator's problems are the port's ``random_multistage_arrays``
(stage blocks, a flat cost ``c``); ``dense`` builds the dense form from
the blocks in plain numpy; the entry stacks them with
``multistage.stage_data_from_arrays``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

NAME = "stage_test"
CELL = f"{NAME}.warm"


def generate(T: int, D: int, Da: int, ra: int, rg: int, seed: int) -> dict:
    """One problem's stage blocks (the keyword arguments of
    ``multistage.from_stage_blocks``)."""
    from piqp_tpu_torch import multistage

    return multistage.random_multistage_arrays(T, D, Da, ra, rg, seed)


def dense(problem: dict, with_cost: bool = True) -> dict:
    """The problem as dense P, c, A, b, G, h_l, h_u, x_l, x_u (no bounds on
    x: +-inf), the cost from the problem's flat ``c``."""
    Pd, Psub, Pa, Pc = (problem[k] for k in ("Pd", "Psub", "Pa", "Pc"))
    T, D = Pd.shape[:2]
    Da = Pc.shape[0]
    n = T * D + Da

    def stage(i):
        return slice(i * D, (i + 1) * D)

    P = np.zeros((n, n))
    for i in range(T):
        P[stage(i), stage(i)] = Pd[i]
        if i + 1 < T:
            P[stage(i + 1), stage(i)] = Psub[i]
            P[stage(i), stage(i + 1)] = Psub[i].T
        P[T * D:, stage(i)] = Pa[i]
        P[stage(i), T * D:] = Pa[i].T
    P[T * D:, T * D:] = Pc

    def rows(M1, M2, Mg):
        r = M1.shape[1]
        M = np.zeros((T * r, n))
        for j in range(T):
            at = slice(j * r, (j + 1) * r)
            M[at, stage(j)] = M1[j]
            if j + 1 < T:
                M[at, stage(j + 1)] = M2[j]
            M[at, T * D:] = Mg[j]
        return M

    out = dict(A=rows(problem["A1"], problem["A2"], problem["Ag"]), b=problem["b"],
               G=rows(problem["G1"], problem["G2"], problem["Gg"]),
               h_l=problem["h_l"], h_u=problem["h_u"],
               x_l=np.full(n, -np.inf), x_u=np.full(n, np.inf))
    if with_cost:
        out.update(P=P, c=problem["c"])
    return out


def enter(problems: list, device):
    """The problems as one stacked ``StageQPData`` on ``device``: the
    port's canonicalisation of each, one host-to-device copy a field."""
    from piqp_tpu_torch import multistage

    return multistage.stage_data_from_arrays([multistage._stage_arrays(**p) for p in problems],
                                             device=device)


def config(T=16, D=3, Da=1, ra=2, rg=2, batch=8, problems=8, block=4) -> dict:
    """The configuration file's contents: ``dense128``'s check limits, the
    multistage backend in mixed precision."""
    return {
        "name": NAME,
        "generator": NAME,
        "sizes": {"T": T, "D": D, "Da": Da, "ra": ra, "rg": rg},
        "fleet_seed": 0,
        "batch": batch,
        "entry": NAME,
        "settings": {"mixed_precision": True, "kkt_solver": "multistage"},
        "check": {"rounds": 2, "problems": problems, "block": block,
                  "limits": {"not_solved": 0, "x_gap": 0.001, "primal_viol": 1e-06}},
    }


def write_bench(folder: Path, bench_file: Path, cfg: dict) -> Path:
    """``bench_file``'s benchmark with the configuration ``cfg`` and its
    cell on the ``warm`` traffic added, written into ``folder``; the cell
    reports ``round_ms`` and ``setup_s`` and, traced, ``lockstep_iters.warm``
    and ``device_idle.warm``."""
    bench = json.loads(Path(bench_file).read_text())
    cfg_path = Path(folder) / f"{NAME}.json"
    cfg_path.write_text(json.dumps(cfg))
    bench["configs"].append({"name": NAME, "source": "test only", "file": str(cfg_path),
                             "reduced": [], "why": "stands for no deployment"})
    bench["workloads"].append({"name": CELL, "config": NAME, "traffic": "warm", "chips": 1,
                               "why": "stands for no deployment"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("round_ms", "lockstep_iters.warm", "device_idle.warm"):
            m["workloads"].append(CELL)
    out = Path(folder) / "BENCHMARK.json"
    out.write_text(json.dumps(bench))
    return out


def register(setitem) -> None:
    """This module as the configuration's generator and entry, found by
    name: ``setitem(byname._LOADED, key, module)`` (``monkeypatch.setitem``
    in a test)."""
    import sys

    from gpubench import byname

    module = sys.modules[__name__]
    for folder in ("generators", "entries"):
        setitem(byname._LOADED, (folder, NAME), module)

