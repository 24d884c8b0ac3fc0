"""Which batched operations of the sharded multistage path give other bits
when fewer matrices share the call, on one CUDA card:

    python3 scripts/batch_bits_probe.py

A rank of the horizon-sharded solve runs each batched product on its own
stages, so a group of 2 or 4 ranks gives the same bits as one rank only
where an operation's bits do not depend on the batch count.  For random
float64 and float32 batches of N matrices, prints for each operation
whether its results on the first N/2, N/4, 17, 3 and 1 matrices alone
equal the same rows of its result on all N: the matrix-vector forms
(``matmul``, ``einsum``, a product and a sum over k as in
``multistage._mv``) at the stage shapes of phase 14 (D = 8 and 48,
the arrow's 4, the coupling width 100), and the chain factor's
matrix-matrix products, Cholesky and triangular solves at D = 48.
Exits nonzero without a card.
"""

from __future__ import annotations

import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("batch_bits_probe: no CUDA device available", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    g = torch.Generator(device="cuda").manual_seed(0)

    def same(f, *args) -> bool:
        N = args[0].shape[0]
        full = f(*args)
        return all(torch.equal(full[:n], f(*(a[:n] for a in args)))
                   for n in (N // 2, N // 4, 17, 3, 1))

    forms = {
        "matmul": lambda M, v: torch.matmul(M, v[..., None])[..., 0],
        "einsum": lambda M, v: torch.einsum("nij,nj->ni", M, v),
        "sum_mv": lambda M, v: (M * v[:, None, :]).sum(-1),
    }
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    for dt in (torch.float64, torch.float32):
        for m, k in ((48, 48), (100, 48), (48, 100), (4, 48), (48, 4), (8, 8), (8, 36)):
            for N in (5632, 512):
                M = torch.randn(N, m, k, device="cuda", dtype=dt, generator=g)
                v = torch.randn(N, k, device="cuda", dtype=dt, generator=g)
                print(f"[matrix-vector {str(dt)[6:]}] N={N} {m}x{k}: " + ", ".join(
                    f"{name} {'same' if same(f, M, v) else 'DIFFERS'}" for name, f in forms.items()))
        N, D, W = 512, 48, 100
        A = torch.randn(N, D, D, device="cuda", dtype=dt, generator=g)
        K = A @ A.mT + D * torch.eye(D, device="cuda", dtype=dt)
        F = torch.randn(N, W, D, device="cuda", dtype=dt, generator=g)
        u = torch.randn(N, D, device="cuda", dtype=dt, generator=g)
        L = torch.linalg.cholesky(K)
        ops = {
            "bmm D x D": lambda K, F, u, L: K @ K.mT,
            "bmm W x D by D x D": lambda K, F, u, L: F @ K.mT,
            "bmm W x D by D x W": lambda K, F, u, L: F @ F.mT,
            "cholesky": lambda K, F, u, L: torch.linalg.cholesky_ex(K)[0],
            "triangular solve, matrix": lambda K, F, u, L: torch.linalg.solve_triangular(
                L, F.mT, upper=False),
            "triangular solve, vector": lambda K, F, u, L: torch.linalg.solve_triangular(
                L, u[..., None], upper=False),
        }
        print(f"[chain {str(dt)[6:]}] N={N} D={D} W={W}: " + ", ".join(
            f"{name} {'same' if same(f, K, F, u, L) else 'DIFFERS'}" for name, f in ops.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
