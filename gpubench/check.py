"""The comparison that decides ``correct``.

Three numbers, each against the limit the configuration file states
(``check.limits``; PERF.md gives the readings each was set from):

- ``not_solved``: problems of the window whose status is not SOLVED, every
  round counted (exact, limit 0);
- ``x_gap``: on the sampled problems (``mixes.sample``), the widest
  ``|x - x_ref|_inf / max(1, |x_ref|_inf)`` against the float64
  reference's solution of the same round's problem;
- ``primal_viol``: on every problem of every round, the widest scaled
  primal violation of x on the original data (equalities, both sides of
  the inequalities, the bounds), as ``reference.optimality`` scales it,
  read in blocks of ``check.block`` problems.

``ref_kkt`` guards the reference itself: its worst KKT violation on the
sampled problems (``reference.optimality``), held to ``REF_KKT_LIMIT``.
On the card it reads at most 4.7e-11 on the dense128 fleet's cold
pool and 1.2e-9 on its warm rounds; the limit stands far above that and
far below what would move x_gap.  The
reference runs after the window, once the program's state
is freed, in blocks of ``check.block`` problems.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mixes, problems as pb, reference

SOLVED = 1
REF_KKT_LIMIT = 1e-6


def primal_violation(dense: dict, xs: np.ndarray, device) -> float:
    """Widest scaled primal violation of the solutions xs (rounds, B, n) of
    the problems ``dense`` (A, b, G and the bounds, stacked over B)."""
    t = {k: torch.as_tensor(np.ascontiguousarray(dense[k]), device=device, dtype=torch.float64)
         for k in ("A", "b", "G", "h_l", "h_u", "x_l", "x_u")}
    worst = 0.0
    for x in xs:
        x = torch.as_tensor(x, device=device, dtype=torch.float64)
        Ax = torch.einsum("bpn,bn->bp", t["A"], x)
        Gx = torch.einsum("bmn,bn->bm", t["G"], x)
        parts = [(Ax - t["b"]).abs(), (Gx - t["h_u"]).clamp(min=0), (t["h_l"] - Gx).clamp(min=0),
                 (x - t["x_u"]).clamp(min=0), (t["x_l"] - x).clamp(min=0)]
        per = torch.stack([p.amax(-1) if p.shape[-1] else torch.zeros_like(x[:, 0])
                           for p in parts]).amax(0)
        scale = x.abs().amax(-1).clamp(min=1.0)
        worst = max(worst, float(torch.nan_to_num(per / scale, nan=np.inf).max()))
    return worst


def blocked_primal_violation(config: dict, problems: list, xs: np.ndarray, device) -> float:
    """``primal_violation`` of the solutions xs (rounds, B, n) of the host
    problems, on the dense form of ``check.block`` problems at a time: the
    reading is a maximum over problems, so the blocks change nothing but
    the memory it takes."""
    block = config["check"]["block"]
    return max(primal_violation(pb.dense_form(config, problems[lo:lo + block], with_cost=False),
                                xs[:, lo:lo + block], device)
               for lo in range(0, len(problems), block))


def x_gaps(x: np.ndarray, x_ref: np.ndarray) -> np.ndarray:
    return np.abs(x - x_ref).max(-1) / np.maximum(1.0, np.abs(x_ref).max(-1))


def reference_solutions(config: dict, traffic: dict, seed: int, picks: list, device,
                        batches=None, dtype=torch.float64) -> list:
    """The reference's (x, worst KKT violation) for each sampled (round,
    problems) pair, solved in blocks of ``check.block`` problems."""
    block = config["check"]["block"]
    out = []
    for r, idx in picks:
        probs = mixes.round_problems(config, traffic, seed, r, batches)
        xs, kkt = [], 0.0
        for lo in range(0, len(idx), block):
            dense = pb.dense_form(config, [probs[i] for i in idx[lo:lo + block]])
            sol = reference.solve(dense, device=device, dtype=dtype)
            xs.append(sol[0])
            if dtype == torch.float64:
                kkt = max(kkt, max(reference.optimality({k: dense[k][i] for k in dense},
                                                         *(s[i] for s in sol[:6]))
                                   for i in range(len(sol[0]))))
        out.append((np.concatenate(xs), kkt))
    return out


def compare(config: dict, traffic: dict, seed: int, window: dict, device) -> dict:
    """The numbers of a run's window (``window``: ``xs``, a list of (B, n)
    arrays, round 1 first; ``statuses``, a list of (B,) arrays) against
    their limits.  Returns {name: (value, limit)}."""
    limits = config["check"]["limits"]
    batches = mixes.pool(config, traffic, seed)
    status = np.stack(window["statuses"])
    numbers = {"not_solved": (float(np.count_nonzero(status != SOLVED)), limits["not_solved"])}

    picks = mixes.sample(traffic, config, seed, len(window["xs"]))
    refs = reference_solutions(config, traffic, seed, picks, device, batches)
    gap = max(float(x_gaps(window["xs"][r - 1][idx], x_ref).max()) for (r, idx), (x_ref, _)
              in zip(picks, refs))
    numbers["x_gap"] = (gap, limits["x_gap"])

    # every round's x against the constraints of the batch it solved
    batch_of = mixes.mode(traffic).batch_of
    worst = 0.0
    for k, probs in enumerate(batches):
        rounds = [i for i in range(len(window["xs"])) if batch_of(traffic, i + 1) == k]
        if rounds:
            worst = max(worst, blocked_primal_violation(
                config, probs, np.stack([window["xs"][i] for i in rounds]), device))
    numbers["primal_viol"] = (worst, limits["primal_viol"])
    numbers["ref_kkt"] = (float(max(k for _, k in refs)), REF_KKT_LIMIT)
    return numbers


def passed(numbers: dict) -> bool:
    return all(np.isfinite(v) and v <= lim for v, lim in numbers.values())
