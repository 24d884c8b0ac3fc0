"""Chip smoke test of the PyTorch/CUDA port (piqp_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, then drives the
port's main path (a batched dense QP solve through the condensed-Cholesky
backend) and each later slice's path at full width and checks what comes
out.  Every phase raises on failure, so any fault gives a nonzero exit
code.  Without a CUDA device, or without the package beside it, the script
exits nonzero and prints no result.

Phases:
  1. device and build: card name and power limit, versions, nvcc time;
  2. K1 (Cholesky with inverse) against its plain version, float32 and
     float64, at n in {8, 33, 64, 128, 169, 170, 200, 225, 226, 240, 241,
     256} (B = 5; both sides of each dtype's limit between the resident
     and the cluster route, and of each cluster-size limit), at every n of
     the cluster route (B = 3), at the main path's shape B = 1024,
     n = 128 and at the n = 256 fleet's B = 256, n = 256, each launch
     checked to take the route ``kernel_route`` and the cluster size
     ``cluster_size`` name; indefinite input on the resident route and on
     each cluster size; times of the resident kernel, the plain version
     and the library at the main path's shape, of the cluster kernel, K3's
     kernel with every sign +1, the plain version and the library at
     B = 256, n = 256, and bounds;
  2b. K2 (Cholesky with inverse and apply) and K3 (signed Cholesky with
     inverse) against their plain versions, float32 and float64.  K2 at
     D in {4, 8, 16, 33, 64, 65, 97, 98, 128, 138, 139, 144, 169, 170, 225,
     226, 240, 241, 256} (N = 5, R = 2D + 4: each side of the resident
     route's limit, 138 / 139 in float32 and 97 / 98 in float64, its first
     256-thread block, and each side of K1's resident / cluster and
     cluster-size limits inside the split route), at D in {75, 76, 107,
     108} with R = 4D + 4 (the chunked and sharded interiors' width), at
     D = 32 with R = 1800 and 900 and D = 33 with R = 300, at D in {1, 4,
     7, 8, 9, 16, 23, 31, 32} with R = 3 and R = 2D + 4 (N = 101, a ragged
     last block), at the multistage fleet's shape N = 12,800, D = 8,
     R = 20, at N = 5,376, D = 23, R = 50, at the horizon path's shapes
     and at every shape phases 17 (D = 48, R = 100) and 18 (D = 144,
     R = 292) launch, each launch checked to take the route
     ``apply_kernel_route`` names (small up to D = 32 where it fits,
     resident where the n x (n + R) square fits one block, split above:
     K1's kernel, on the route and cluster size ``kernel_route`` and
     ``cluster_size`` name, then the product kernel; the horizon shapes
     small, phase 17's resident, phase 18's split); an indefinite block in
     the middle of a batch and as the last group of a warp, on the small
     route, in the middle of a batch on the resident route and on the
     split route with a resident and with a cluster factor; at the two
     large small-route shapes the small kernel's device time (a CUDA graph
     of launches) with warm and cold L2 and its looped time, and at the
     fleet's shape the plain version's and the library's; at N = 2,560,
     D in {48, 64}, R = 2D + 4 the resident kernel's device and looped
     times beside the library route's (both products included; looped and
     by device time), the bound, and at D = 48 the plain version's; at
     phase 18's first level, N = 1,280, D = 144, R = 292, the split
     route's device and looped times, its two kernels' device times, the
     library route's, the plain version's and the bound.  K3 at
     Np in {64, 128, 168, 169, 192, 224, 225, 239, 240, 256} (B = 5, mixed
     sign patterns; both sides of each dtype's cluster-size limits) and at
     the dense_ldlt fleet's shape B = 256, Np = 256, each launch checked to
     take the route and cluster size ``kernel_route`` and ``cluster_size``
     name; wrong-sign poisoning on a one-block and a clustered shape; times
     and bounds at the fleet's shape (the resident kernel at B = 256 and
     B = 64, the blocked route and the plain version);
  3. main path: 1024 problems dense_strongly_convex_qp(128, 64, 64,
     seed=1000+i) (the benchmarks/make_batch.py set), cold with
     mixed precision and one warm re-solve round, with K1 launch counts
     per dtype and per route (all resident) and a host-side KKT optimality
     check of every result;
  4. float64 batch (B = 64), one DenseSolver on the card, and the first 8
     problems run again on the CPU (plain versions), in float64 and with
     mixed precision;
  5. a profile of the warm round (kernel time by name, K1's share, device
     busy share);
  6. dense_ldlt fleet: the first 256 problems of phase 3 through the full
     3-block KKT backend (K3), mixed cold, one warm round and a float64
     cold solve of 64, plus a float64 dense_lu batch of 64, with K3 launch
     counts per dtype, route (all resident) and cluster size;
  7. multistage fleet: 256 problems random_multistage_qp(T=100, D=8, Da=4,
     ra=4, rg=4, seed=4+i) (cyclic reduction, 7 levels of K2), mixed cold,
     one warm round and a float64 cold solve of 64; then 8 problems at
     T = 272 (the chunked scheme with cyclic-reduction interiors), float64;
     every K2 launch of these runs checked to take the small kernel;
  8. SparseSolver: one T = 100 problem as scipy CSC through structure
     detection (the port's C++ library), solve, update(c), warm solve;
  9. the first 4 problems of phases 6 and 7 again on the CPU, and a profile
     of one warm round of each new fleet;
 10. dense differentiable fleet: 256 QPs at n = 128, p = 64, m = 64 with a
     planted nondegenerate active set (inverse KKT, as tests/test_diff.py
     builds them), float64 at eps_abs = 1e-10, ``solve_qp_diff`` and the
     backward pass of sum(v . x): every forward SOLVED, central finite
     differences in c, b, h_u and P for problems 0-3, their gradients
     against the port on the CPU, K1 launches in the forward (all
     resident), forward and backward ms;
 11. stage differentiable fleet: the phase-7 fleet in float64 through
     ``solve_qp_diff``, gradients of sum(x^2) in c and Pd, finite
     differences and the CPU port for problems 0-3, K2 launches in the
     backward alone (the adjoint factor; all small), forward and backward
     ms;
 12. SQP rounds and compaction on the phase-3 fleet (mixed precision):
     ``solve_batch_sqp`` (4 rounds from the cold result) against 4
     sequential warm ``solve_batch`` rounds, ``solve_batch_compact``
     (phase 1 of 4 iterations) against the one-pass warm round, host KKT
     checks, wall times and effective iterations per problem;
 13. ``compute_timings`` on a ``DenseSolver`` on the card (six time
     fields filled), and ``SparseSolver`` with ``kkt_solver=sparse_host``
     at n = 600 against the card's dense solve of the same problem;
 14. horizon sharding on a NCCL process group of one rank (FileStore in a
     temporary directory; a gloo group beside it for the CPU): BASELINE
     config 4, one problem random_multistage_qp(T=100, D=8, Da=4, ra=4,
     rg=4, seed=4), through ``solve_horizon_sharded`` at 4 chunks
     (cyclic-reduction interiors, one K2 launch a level) and 8 chunks
     (T padded to 104, chain interiors), float64 and mixed, cold and a
     warm re-solve after c *= 1.01, each held against the sequential
     solve on the card, the sharded solve on the CPU and the host KKT
     check; the phase-7 fleet at 4 chunks, mixed cold and one warm round,
     against phase 7; ``solve_batch(sharding=group)`` on phase 3's fleet,
     identical to phase 3's cold round; K2 launches by route (all small,
     more than 0 at 4 chunks) and the sharded-call counter.  Then the
     rank-local layout on 1, 2 and 4 ranks of the one card: config 4 at 4
     chunks, float64 and mixed, cold and warm, and phase 17's D = 48
     fleet (128 problems, T = 41 padded to 44, chain interiors) float64
     cold, each handed over on the host and placed by
     ``shard_horizon(..., device="cuda")``, on the NCCL rank (the
     reference, checked on the host) and on 2 and 4 gloo ranks spawned on
     the card (NCCL refuses two ranks of one device): every rank's x
     identical, float64 iterations equal and x within XCHECK_F64_TOL of
     one rank's, mixed SOLVED, optimal on the host and within
     XCHECK_MIXED_TOL, each rank's stage-block bytes exactly its share,
     K2's small kernel in every config-4 run at phase 2b's shapes, the
     fleet's peak memory falling from 1 to 2 to 4 ranks; each rank's
     peak memory and host-clock time printed (the ranks share one card:
     no speed-up across GPUs is shown or claimed).
 15. the C interface (piqp_tpu_torch/capi/): build_capi.sh builds the
     library and its C driver; the driver's file-driven mode on CUDA solves
     phase 3's problem 0 (n = 128) through K1 in float64 (the library's
     default settings) and mixed precision, through K3 (Np = 256) and with
     the library factorizations, and phase 8's T = 100 problem as CSC
     through K2, each cold and warm after an update of c; every C result
     SOLVED, optimal on the host, and equal to the Python entry's solve in
     this process (float64: iterations equal, |dx| <= 1e-9; mixed: status
     equal, |dx| <= 1e-4), whose launches are counted by route; the same
     runs through the Python entry points in a fresh process, the control
     for the C calls' seconds; one device-to-host copy a result; then the
     three examples (examples/torch_*.py) on the card;
 16. the n = 256 dense fleet: 256 problems dense_strongly_convex_qp(256,
     128, 128, seed=1000+i) (benchmarks/make_batch.py's batch_problems(256,
     256)), mixed cold and one warm round after c += 1e-3 N(0, 1), and a
     float64 cold round of the first 64, every K1 launch on the cluster
     route (2-block clusters in float32, 3-block in float64); problems 0-1
     again on the CPU (float64: equal iterations, |dx| <= 1e-9; mixed:
     equal status, |dx| <= 1e-4); one float64 DenseSolver at n = 200
     (p = m = 100; cluster route, 2 blocks), cold and warm; a profile of
     the fleet's warm round;
 17. the D = 48 multistage fleet: 128 problems random_multistage_qp(T=41,
     D=48, Da=4, ra=4, rg=4, seed=4000+i) (the chain-of-masses fixture's
     horizon with a stage twice as wide; cyclic reduction, K2 at N = 2,560,
     1,280, 640, 384, 128 and 128 with R = 100, the bound of each), mixed
     cold and one warm round after c += 1e-3 N(0, 1), and a float64 cold
     round of the first 32, every K2 launch on the resident route, by
     dtype and route; host KKT checks of every problem; problems 0-1 again
     on the CPU (float64: equal iterations, |dx| <= 1e-9; mixed: equal
     status, |dx| <= 1e-4); a profile of the warm round with K2's share;
 18. the D = 144 multistage fleet: 64 problems random_multistage_qp(T=41,
     D=144, Da=4, ra=4, rg=4, seed=5000+i) (n = 5,908; the narrowest
     stage at which both dtypes take K2's split route; K2 at N = 1,280,
     640, 320, 192, 64 and 64 with R = 292, the bound of each), mixed cold
     and one warm round after c += 1e-3 N(0, 1), and a float64 cold round
     of the first 16, every K2 launch on the split route with its factor
     on K1's resident kernel, by dtype and route; host KKT checks of every
     problem (sparse, from the stage blocks); problems 0-1 again on the
     CPU (float64: equal iterations, |dx| <= 1e-9; mixed: equal status,
     |dx| <= 1e-4); a profile of the warm round with the factor's and the
     product kernel's shares.  Phases 17 and 18 check the KKT conditions
     on sparse matrices assembled from the stage blocks.
The line before the last lists the kernels as JSON; the last line is the
device summary.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks from NVIDIA's H100 data sheet, the highest rate of each
# type: float32 outside the tensor cores, float64 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}

MAIN_B, MAIN_N, MAIN_P, MAIN_M = 1024, 128, 64, 64
# phase 16: the n = 256 dense fleet (benchmarks/make_batch.py's
# batch_problems(256, 256), p = m = n / 2), above K1's resident limit in
# both dtypes, its float64 batch, and one float64 DenseSolver at n = 200,
# above the limit in float64 alone (the C interface's default type)
N256_B, N256_N, N256_B64 = 256, 256, 64
N200 = 200
# K1's (B, n): both sides of the resident limit (169/170 float64, 240/241
# float32) and of the float64 cluster-size limit (225/226: 2 / 3 blocks),
# the main path's shape and the n = 256 fleet's
K1_SHAPES = [(5, 8), (5, 33), (5, 64), (5, 128), (5, 169), (5, 170), (5, 200), (5, 225),
             (5, 226), (5, 240), (5, 241), (5, 256), (MAIN_B, MAIN_N), (N256_B, N256_N)]
K1_TOL = {"float32": 5e-5, "float64": 1e-11}
# K2's Y = K^-1 RHS against its plain version, relative to max |Y_ref|
K2_Y_RTOL = {"float32": 1e-5, "float64": 1e-13}
# the dense_ldlt fleet: n + p + m = 256, so K3 runs at its largest shape
LDLT_B = 256
# the multistage fleet (benchmarks/horizon_bench.py's shape at BASELINE
# config 4's horizon): n = 804, p = 400, m = 400
MS_B, MS_T, MS_D, MS_DA, MS_RA, MS_RG = 256, 100, 8, 4, 4, 4
# K2's (N, D, R): the split route's shapes, R = 2D + 4; every n of the
# small kernel with R below and above its group's lanes, at an N that no
# block's matrix count divides (a ragged last block); then the timed
# shapes, the multistage fleet's first level and the scenario_mpc-shaped
# cell's (256 problems at T = 43, D = 23, Da = 4: 21 odd blocks each)
K2_RAGGED_N = 101
K2_FLEET = (MS_B * MS_T // 2, MS_D, 2 * MS_D + MS_DA)
K2_D23 = (256 * (43 // 2), 23, 2 * 23 + 4)
# BASELINE config 4 (benchmarks/horizon_bench.py:20,63): one problem of
# the multistage fleet's shape, solved horizon-sharded.  At 4 chunks each
# chunk's Qi = 24 interior stages take cyclic-reduction levels of 12, 6,
# 3, 1 and 1 odd blocks, each with the right-hand side [S_in | S_out' |
# Ea'] of R = 2D + W = 4D + Da columns: K2 launches at N = 4 chunks x
# those blocks for config 4 and MS_B times that for the fleet
CFG4_SEED = 4
# phase 14's ranks on the one card: config 4 at 4 chunks over 1, 2 and 4
# ranks (4, 2 and 1 chunks a rank), so a rank's K2 launches take N = 4, 2
# and 1 x the level's blocks; the phase-7 fleet at 4 chunks on one rank
HZ_CHUNKS, HZ_WORLDS = 4, (2, 4)
K2_HORIZON = sorted({(c * h, MS_D, 4 * MS_D + MS_DA) for c in (1, 2, 4) for h in (12, 6, 3, 1)}
                    | {(MS_B * HZ_CHUNKS * h, MS_D, 4 * MS_D + MS_DA) for h in (12, 6, 3, 1)}
                    | {(K2_RAGGED_N, MS_D, 4 * MS_D + MS_DA)})
# phase 17: the D = 48 multistage fleet, 128 problems at the chain-of-masses
# SQP fixture's horizon (T = 41) with a stage twice as wide; cyclic
# reduction takes levels of 20, 10, 5, 3, 1 and 1 odd blocks, so K2 runs
# at N = 128 times those, n = 48, R = 2D + Da = 100 (the resident route),
# and its float64 round of 32 at a quarter of each N
MS48_B, MS48_T, MS48_D, MS48_DA, MS48_B64 = 128, 41, 48, 4, 32
MS48_LEVELS = (20, 10, 5, 3, 1, 1)
K2_MS48 = sorted({(b * h, MS48_D, 2 * MS48_D + MS48_DA)
                  for b in (MS48_B, MS48_B64) for h in MS48_LEVELS})
# phase 18: the D = 144 multistage fleet, 64 problems at the same horizon
# with a stage three times phase 17's, the narrowest at which both dtypes
# take K2's split route (float32 from D = 139, float64 from 98); K2 at
# N = 64 times phase 17's levels, n = 144, R = 292, and its float64 round
# of 16 at a quarter of each N
MS144_B, MS144_D, MS144_B64 = 64, 144, 16
K2_MS144 = sorted({(b * h, MS144_D, 2 * MS144_D + MS48_DA)
                   for b in (MS144_B, MS144_B64) for h in MS48_LEVELS})
K2_SPLIT_TIMED = max(K2_MS144)
# K2's wide timed shapes (D > 32, where the small kernel stops): 2,560
# blocks, R = 2D + 4; D = 48 is the phase-17 fleet's first level
K2_WIDE_TIMED = [(2560, D, 2 * D + 4) for D in (48, 64)]
# each side of the resident square's limit at R = 2D + 4 (138 / 139 in
# float32, 97 / 98 in float64), n = 65 (the first 256-thread block), each
# side of K1's limits inside the split route (resident / cluster 169 / 170
# float64 and 240 / 241 float32; 2 / 3 blocks 225 / 226 float64), the
# resident / split limit at R = 4D + 4 (75 / 76 float64, 107 / 108
# float32), right-hand blocks too wide for the small route (D = 32) or
# wider than one register tile (D = 33)
K2_SHAPES = ([(5, D, 2 * D + 4) for D in (4, 8, 16, 33, 64, 65, 97, 98, 128, 138, 139, 144,
                                          169, 170, 225, 226, 240, 241, 256)]
             + [(5, D, 4 * D + 4) for D in (75, 76, 107, 108)]
             + [(5, 32, 1800), (5, 32, 900), (5, 33, 300)]
             + [(K2_RAGGED_N, D, R) for D in (1, 4, 7, 8, 9, 16, 23, 31, 32)
                for R in (3, 2 * D + 4)]
             + [K2_FLEET, K2_D23] + K2_HORIZON + sorted(set(K2_MS48 + K2_WIDE_TIMED))
             + K2_MS144)
# rotated input sets of the cold-L2 timing: more than the 50 MB L2 holds
K2_COLD_SETS = 8
K3_SHAPES = [(5, 64), (5, 128), (5, 168), (5, 169), (5, 192), (5, 224), (5, 225), (5, 239),
             (5, 240), (5, 256), (LDLT_B, 256)]
# the float64 dense_ldlt batch
LDLT_B64 = 64
OPT_TOL = 1e-6
# the differentiable fleets: float64 solved tight, gradients of problems
# 0-3 held to central differences (step 1e-6) and to the port on the CPU.
# The duality-gap limits are tightened with the residual ones: at the
# default 1e-8 the IPM stops with mu ~ 6e-10, an active row with z ~ 5e-4
# keeps s ~ mu/z ~ 1e-6, and the implicit derivative, which weighs that
# row by z/s, then differs from central differences by up to 4e-3
# (multistage problem 0 on the CPU).  The stage fleet is held to
# tests/test_diff.py's multistage tolerance; the dense one to rel 1e-3,
# not the n = 6 test's 2e-4: the slack floor (diff.SLACK_FLOOR) caps an
# active row's weight at z/1e-8 ~ 1.5e8, and at n = 128 that finite weight
# moves the implicit derivative up to 3e-4 from the active-set derivative,
# which central differences reproduce (the JAX package's gradient moves
# the same: 0.0194109 against 0.0194051 for problem 2 along P; an exact
# dense solve of the same saddle system gives the port's value)
DIFF_B, DIFF_ACTIVE, DIFF_BOXES = 256, 16, 8
DIFF_TIGHT = dict(eps_abs=1e-10, eps_rel=1e-11, eps_duality_gap_abs=1e-12,
                  eps_duality_gap_rel=1e-13)
FD_REL, FD_ABS, FD_STAGE_REL = 1e-3, 5e-6, 5e-4
GRAD_XCHECK_REL = 1e-6
SQP_ROUNDS = 4
# x of a mixed-precision solve on the CPU vs the card: the float32 phase
# takes different (equally optimal) trajectories on the two devices; on
# these problems the JAX package's own mixed run and the port's CPU run
# differ by up to 1.7e-5 in x
XCHECK_MIXED_TOL = 1e-4
# x of a float64 solve on the CPU vs the card at n = 256 and 200: both
# follow the same trajectory (equal iterations), so x agrees to rounding
XCHECK_F64_TOL = 1e-9
# two mixed-precision solves of one fleet by different factorizations (the
# horizon-sharded fleet against phase 7), each stopping near, not at, the
# float64 optimum: scripts/horizon_fleet.py finds the phase-7 fleet's mixed
# x up to 1.08e-4 (sequential, problem 230) and 1.17e-4 (sharded at 4
# chunks, problem 130) from its float64 x on an H100, and up to 8.9e-5 and
# 9.9e-5 on the CPU.  A judgement, not a bound: the pair observed on an
# H100 sits 1.08e-4 apart
XCHECK_MIXED_PAIR_TOL = 2 * XCHECK_MIXED_TOL


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, count: int = 20, windows: int = 3) -> float:
    """Time per call of ``fn``: CUDA events around a loop of ``count``
    calls, divided by the count, after two warm-up calls; the median of
    ``windows`` such loops.  The calls are queued back to back, so the
    wrapper's host work overlaps the previous launch."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(count):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / count)
    return statistics.median(times)


def _graph_ms(torch, fns, count: int = 24, windows: int = 3) -> float:
    """Device time per call: ``count`` calls, taking ``fns`` in turn,
    captured into one CUDA graph after a warm-up call of each, and CUDA
    events around a replay; the median of ``windows`` replays.  The graph
    holds no host work, so a short kernel is timed without the wrapper's."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for c in range(count):
            fns[c % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / count)
    del graph
    return statistics.median(times)


def _spd_batch(torch, B, n, dtype, seed):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(-1, 1, (B, n, n))
    K = Q @ np.swapaxes(Q, 1, 2) + n * np.eye(n)
    return torch.as_tensor(K, dtype=dtype, device="cuda")


def _optimality(prob: dict, x, y, z_l, z_u, z_bl, z_bu) -> float:
    """Worst scaled violation of the KKT conditions of one solution on the
    original data, in float64 (tests/helpers.check_optimality's checks):
    primal feasibility, dual feasibility, stationarity, duality gap.  P, A
    and G are dense arrays (P read from its upper triangle) or
    scipy.sparse matrices (P whole, as ``_stage_problem_sparse`` builds
    it)."""
    import scipy.sparse as sp

    c, A, b = prob["c"], prob["A"], prob["b"]
    h_l, h_u, x_l, x_u = prob["h_l"], prob["h_u"], prob["x_l"], prob["x_u"]
    inf = 1e30
    hl, hu, xl, xu = h_l > -inf, h_u < inf, x_l > -inf, x_u < inf
    if sp.issparse(prob["P"]):
        P = prob["P"]
        G = (sp.diags((hl | hu).astype(float)) @ prob["G"]).tocsr()
    else:
        P = np.triu(prob["P"]) + np.triu(prob["P"], 1).T
        G = prob["G"].copy()
        G[~hl & ~hu] = 0.0
    scale = max(1.0, np.abs(x).max(initial=0.0))
    Gx = G @ x
    primal = max(
        np.abs(A @ x - b).max(initial=0.0),
        np.maximum(Gx[hu] - h_u[hu], 0).max(initial=0.0),
        np.maximum(h_l[hl] - Gx[hl], 0).max(initial=0.0),
        np.maximum(x[xu] - x_u[xu], 0).max(initial=0.0),
        np.maximum(x_l[xl] - x[xl], 0).max(initial=0.0),
    ) / scale
    dual = max(0.0, -min(z_l.min(initial=0), z_u.min(initial=0),
                         z_bl.min(initial=0), z_bu.min(initial=0)))
    grad = P @ x + c + A.T @ y + G.T @ (z_u - z_l) + z_bu - z_bl
    gscale = max(1.0, np.abs(P @ x).max(initial=0.0), np.abs(c).max(initial=0.0))
    primal_obj = 0.5 * x @ P @ x + c @ x
    dual_obj = (-0.5 * x @ P @ x - b @ y + np.where(hl, h_l, 0) @ z_l
                - np.where(hu, h_u, 0) @ z_u + np.where(xl, x_l, 0) @ z_bl
                - np.where(xu, x_u, 0) @ z_bu)
    gap = abs(primal_obj - dual_obj) / max(1.0, abs(primal_obj))
    return max(primal, dual, np.abs(grad).max() / gscale, gap)


def _check_round(problems, res, what: str) -> float:
    """All SOLVED and every solution optimal on the host; returns the worst
    violation."""
    status = res.info.status.cpu().numpy()
    if not np.all(status == 1):
        bad = np.nonzero(status != 1)[0]
        raise AssertionError(f"{what}: {bad.size} problems not SOLVED, e.g. "
                             f"{bad[:5].tolist()} -> {status[bad[:5]].tolist()}")
    host = {k: getattr(res, k).double().cpu().numpy()
            for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu")}
    worst = max(
        _optimality(prob, *(host[k][i] for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu")))
        for i, prob in enumerate(problems)
    )
    if not worst <= OPT_TOL:
        raise AssertionError(f"{what}: KKT violation {worst:.3e} > {OPT_TOL}")
    return worst


def _reset_counts() -> None:
    """Zero the launch counts of every kernel wrapper."""
    from piqp_tpu_torch.ops import chol_inv, signed_chol_inv

    for counts in (chol_inv.launches_by_dtype, chol_inv.launches_by_route,
                   chol_inv.launches_by_cluster,
                   chol_inv.apply_launches_by_dtype, chol_inv.apply_launches_by_route,
                   chol_inv.apply_factor_launches_by_route,
                   chol_inv.apply_factor_launches_by_cluster, signed_chol_inv.launches_by_dtype,
                   signed_chol_inv.launches_by_route, signed_chol_inv.launches_by_cluster):
        for k in counts:
            counts[k] = 0


def _apply_batch(torch, N, D, R, dtype, seed):
    """(K, RHS): N SPD D x D blocks and N right-hand D x R blocks."""
    K = _spd_batch(torch, N, D, dtype, seed=seed)
    RHS = torch.as_tensor(np.random.default_rng(seed).uniform(-1, 1, (N, D, R)),
                          dtype=dtype, device="cuda")
    return K, RHS


def _quasidef_batch(torch, B, n, dtype, seed):
    """(K, signs): a batch of quasi-definite matrices [[H, C'], [C, -M]]
    (H, M positive definite, n/2 rows each) under one random symmetric
    permutation, which keeps them factorizable without pivoting (Vanderbei
    1995) and mixes the sign pattern."""
    rng = np.random.default_rng(seed)
    k = n // 2
    Q1 = rng.uniform(-1, 1, (B, k, k))
    Q2 = rng.uniform(-1, 1, (B, n - k, n - k))
    K = np.zeros((B, n, n))
    K[:, :k, :k] = Q1 @ np.swapaxes(Q1, 1, 2) + k * np.eye(k)
    K[:, k:, k:] = -(Q2 @ np.swapaxes(Q2, 1, 2) + (n - k) * np.eye(n - k))
    C = rng.uniform(-1, 1, (B, n - k, k))
    K[:, k:, :k] = C
    K[:, :k, k:] = np.swapaxes(C, 1, 2)
    signs = np.concatenate([np.ones(k), -np.ones(n - k)])
    perm = rng.permutation(n)
    K, signs = np.ascontiguousarray(K[:, perm][:, :, perm]), signs[perm]
    return (torch.as_tensor(K, dtype=dtype, device="cuda"),
            torch.as_tensor(signs, dtype=dtype, device="cuda"))


def _factor_elements(B, n):
    """Elements a factor-with-inverse of B symmetric n x n matrices must
    move: each matrix's lower triangle read, its L and Linv written whole
    (zeros included)."""
    return B * (n * (n + 1) // 2 + 2 * n * n)


def _bound(name, nbytes, flops):
    """(bound_ms, bound_by) on the card's data-sheet peaks.  A Cholesky
    factor and a triangular inverse of an n x n matrix take about n^3/3
    flops each."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FLOPS[name] * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


def _check_k2(torch, smi) -> list:
    """K2 against its plain version on the card on every kernel route;
    device, looped and cold-L2 times at the fleet's shape and at D = 23, the
    resident route's at D = 48 and 64, the split route's at phase 18's first
    level."""
    from piqp_tpu_torch.ops import chol_inv

    def routed(K, RHS):
        """cholesky_inverse_apply, checked to launch the route
        apply_kernel_route names and, on the split route, to factor on the
        route and cluster size kernel_route and cluster_size name; returns
        the route's label and the outputs."""
        n, dtype = K.shape[-1], K.dtype
        route = chol_inv.apply_kernel_route(n, dtype, RHS.shape[-1])
        counts = (chol_inv.apply_launches_by_route, chol_inv.apply_factor_launches_by_route,
                  chol_inv.apply_factor_launches_by_cluster)
        before = [dict(c) for c in counts]
        out = chol_inv.cholesky_inverse_apply(K, RHS)
        grown = [{k: c[k] - b[k] for k in b} for c, b in zip(counts, before)]
        factor = chol_inv.kernel_route(n, dtype) if route == "split" else None
        cluster = chol_inv.cluster_size(n, dtype) if factor == "cluster" else None
        want = [{k: int(k == key) for k in b} for key, b in zip((route, factor, cluster), before)]
        if grown != want:
            raise AssertionError(f"K2 n={n} r={RHS.shape[-1]} {dtype}: route {route}, factor "
                                 f"{factor}, cluster {cluster}, launches {grown}")
        label = route if factor is None else f"split/{factor}" + (
            f" c={cluster}" if cluster else "")
        return route, label, out

    def library_of(K, RHS):
        """The library route (cholesky_ex, solve_triangular, both
        products), one PyTorch composition the port never calls."""
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device="cuda").expand_as(K)

        def library():
            Lc = torch.linalg.cholesky_ex(K)[0]
            Li = torch.linalg.solve_triangular(Lc, eye, upper=False)
            return Li.mT @ (Li @ RHS)

        return library

    def bound(name, K, RHS):
        N, D, R = RHS.shape
        return _bound(name, (_factor_elements(N, D) + 2 * N * D * R) * K.element_size(),
                      N * (2 * D ** 3 / 3 + 2 * D * D * R))

    entries = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        tol = K1_TOL[name]
        worst_route = {}
        for N, D, R in K2_SHAPES:
            K, RHS = _apply_batch(torch, N, D, R, dtype, seed=D + R)
            route, label, (L, Linv, Y) = routed(K, RHS)
            if (N, D, R) in K2_HORIZON and route != "small":
                raise AssertionError(f"K2 {name} N={N} D={D} R={R}: the horizon path's shape "
                                     f"takes the {route} route")
            if (N, D, R) in K2_MS48 + K2_WIDE_TIMED and route != "resident":
                raise AssertionError(f"K2 {name} N={N} D={D} R={R}: the D = 48 fleet's or a "
                                     f"timed wide shape takes the {route} route")
            if (N, D, R) in K2_MS144 and route != "split":
                raise AssertionError(f"K2 {name} N={N} D={D} R={R}: the D = 144 fleet's shape "
                                     f"takes the {route} route")
            torch.cuda.synchronize()
            L_ref, Linv_ref, Y_ref = chol_inv.chol_inv_apply_reference(K, RHS)
            eye = torch.eye(D, dtype=dtype, device="cuda")
            err_L = (L - L_ref).abs().max().item()
            err_I = (L @ Linv - eye).abs().max().item()
            err_Y = (Y - Y_ref).abs().max().item()
            print(f"[K2 {name}] {label} N={N} D={D} R={R}: |L-L_ref| {err_L:.3e} "
                  f"|L Linv - I| {err_I:.3e} |Y-Y_ref| {err_Y:.3e}")
            if not (err_L <= tol * max(1.0, L_ref.abs().max().item())
                    and err_I <= 50 * tol
                    and err_Y <= K2_Y_RTOL[name] * Y_ref.abs().max().item()):
                raise AssertionError(f"K2 {name} {label} N={N} D={D} R={R} disagrees with its "
                                     f"plain version")
            if bool(torch.triu(L, 1).any()) or bool(torch.triu(Linv, 1).any()):
                raise AssertionError(f"K2 {name} {label} D={D}: nonzero upper triangle")
            worst_route[route] = max(worst_route.get(route, 0.0), err_L, err_Y)
        # one indefinite block gives non-finite output for itself only: in
        # the middle of a batch, and as the last group of a warp whose
        # neighbours share its warp and the next one; on the split route
        # with a resident and with a cluster factor
        for N, D, R, bad in ((4, 12, 28, 2), (8, 8, 20, 3), (16, 3, 10, 7), (5, 48, 100, 2),
                             (5, 144, 292, 2), (5, 256, 516, 2)):
            K = _spd_batch(torch, N, D, dtype, seed=1)
            K[bad, D // 2, D // 2] = -1e3
            route, label, (L, Linv, Y) = routed(
                K, torch.ones((N, D, R), dtype=dtype, device="cuda"))
            fin = [bool(torch.isfinite(a[i]).all()) for i in range(N) for a in (L, Linv, Y)]
            want = [i != bad for i in range(N) for _ in range(3)]
            print(f"[K2 {name}] {label} N={N} D={D}: indefinite block {bad}, finite blocks "
                  f"{[i for i in range(N) if fin[3 * i]]}")
            if fin != want:
                raise AssertionError(f"K2 {name} {label} D={D}: indefinite block {bad} gave "
                                     f"finite flags {fin}")

        timed = {}
        for N, D, R in (K2_FLEET, K2_D23):
            K, RHS = _apply_batch(torch, N, D, R, dtype, seed=7)
            if chol_inv.apply_kernel_route(D, dtype, R) != "small":
                raise AssertionError(f"K2 {name} D={D} R={R} is not routed to the small kernel")
            sets = [_apply_batch(torch, N, D, R, dtype, seed=100 + i) for i in range(K2_COLD_SETS)]
            small = lambda: chol_inv.cholesky_inverse_apply(K, RHS)
            t = dict(
                ms=_graph_ms(torch, [small]),
                ms_cold_l2=_graph_ms(torch, [lambda a=a: chol_inv.cholesky_inverse_apply(*a)
                                             for a in sets]),
                looped_ms=_time_ms(torch, small),
            )
            del sets
            t["bound_ms"], t["bound_by"] = bound(name, K, RHS)
            if (N, D, R) == K2_FLEET:
                t["library_ms"] = _time_ms(torch, library_of(K, RHS))
                t["plain_ms"] = _time_ms(torch, lambda: chol_inv.chol_inv_apply_reference(K, RHS),
                                         count=3, windows=1)
            l2 = " (under the HBM bound: it reads the L2)" if t["ms"] < t["bound_ms"] else ""
            print(f"[K2 {name}] N={N} D={D} R={R}: small kernel device {t['ms']:.4f} ms warm L2"
                  f"{l2}, {t['ms_cold_l2']:.4f} ms cold L2, looped {t['looped_ms']:.4f} ms; bound "
                  f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}), cold/bound "
                  f"{t['ms_cold_l2'] / t['bound_ms']:.2f}x; {smi}")
            if "plain_ms" in t:
                print(f"[K2 {name}] N={N} D={D} R={R}: plain {t['plain_ms']:.4f} ms, library "
                      f"{t['library_ms']:.4f} ms; {smi}")
            timed[D] = t
        # the resident kernel at the wide shapes against the library route
        # (both products included)
        wide = {}
        for N, D, R in K2_WIDE_TIMED:
            K, RHS = _apply_batch(torch, N, D, R, dtype, seed=7)
            if chol_inv.apply_kernel_route(D, dtype, R) != "resident":
                raise AssertionError(f"K2 {name} D={D} R={R} is not routed to the resident kernel")
            kernel = lambda: chol_inv.cholesky_inverse_apply(K, RHS)
            library = library_of(K, RHS)
            g = dict(ms=_graph_ms(torch, [kernel]), looped_ms=_time_ms(torch, kernel),
                     library_ms=_time_ms(torch, library),
                     library_graph_ms=_graph_ms(torch, [library]))
            g["bound_ms"], g["bound_by"] = bound(name, K, RHS)
            if D == MS48_D:
                g["plain_ms"] = _time_ms(torch, lambda: chol_inv.chol_inv_apply_reference(K, RHS),
                                         count=3, windows=1)
            print(f"[K2 {name}] resident N={N} D={D} R={R}: kernel device {g['ms']:.4f} ms, "
                  f"looped {g['looped_ms']:.4f} ms; library route looped {g['library_ms']:.4f} "
                  f"ms, device {g['library_graph_ms']:.4f} ms; library/kernel looped "
                  f"{g['library_ms'] / g['looped_ms']:.2f}x; bound {g['bound_ms'] * 1e3:.2f} us "
                  f"({g['bound_by']}), device/bound {g['ms'] / g['bound_ms']:.2f}x; {smi}")
            if "plain_ms" in g:
                print(f"[K2 {name}] resident N={N} D={D} R={R}: plain {g['plain_ms']:.4f} ms; "
                      f"{smi}")
            wide[D] = g
        # the split route at phase 18's first level: the route, each of its
        # two kernels alone, the library route and the plain version
        N, D, R = K2_SPLIT_TIMED
        K, RHS = _apply_batch(torch, N, D, R, dtype, seed=7)
        if chol_inv.apply_kernel_route(D, dtype, R) != "split":
            raise AssertionError(f"K2 {name} D={D} R={R} is not routed to the split route")
        factor = chol_inv.kernel_route(D, dtype)
        _, Linv, _ = chol_inv.cholesky_inverse_apply(K, RHS)
        split = lambda: chol_inv.cholesky_inverse_apply(K, RHS)
        library = library_of(K, RHS)
        sp_t = dict(ms=_graph_ms(torch, [split]), looped_ms=_time_ms(torch, split),
                    factor_ms=_graph_ms(torch, [lambda: chol_inv._launch_factor(K, factor)]),
                    product_ms=_graph_ms(torch, [lambda: chol_inv._launch_product(Linv, RHS)]),
                    library_ms=_time_ms(torch, library),
                    library_graph_ms=_graph_ms(torch, [library]),
                    plain_ms=_time_ms(torch, lambda: chol_inv.chol_inv_apply_reference(K, RHS),
                                      count=3, windows=1))
        sp_t["bound_ms"], sp_t["bound_by"] = bound(name, K, RHS)
        print(f"[K2 {name}] split N={N} D={D} R={R}: route device {sp_t['ms']:.4f} ms, looped "
              f"{sp_t['looped_ms']:.4f} ms; factor ({factor}) {sp_t['factor_ms']:.4f} ms "
              f"({100 * sp_t['factor_ms'] / sp_t['ms']:.1f}%), product "
              f"{sp_t['product_ms']:.4f} ms ({100 * sp_t['product_ms'] / sp_t['ms']:.1f}%); "
              f"library route looped {sp_t['library_ms']:.4f} ms, device "
              f"{sp_t['library_graph_ms']:.4f} ms; library/split looped "
              f"{sp_t['library_ms'] / sp_t['looped_ms']:.2f}x; plain {sp_t['plain_ms']:.4f} ms; "
              f"bound {sp_t['bound_ms']:.4f} ms ({sp_t['bound_by']}), device/bound "
              f"{sp_t['ms'] / sp_t['bound_ms']:.2f}x; {smi}")
        fleet = timed[K2_FLEET[1]]
        entries.append(dict(
            name=f"chol_inv_apply_{name}", route="cuda", kernel_route="small",
            source="piqp_tpu_torch/csrc/chol_inv_apply_small.cu",
            replaces="piqp_tpu/ops/pallas_chol.py:270",
            launches=None, max_abs_err=worst_route["small"], ms=fleet["ms"],
            ms_cold_l2=fleet["ms_cold_l2"], looped_ms=fleet["looped_ms"],
            library_ms=fleet["library_ms"], plain_ms=fleet["plain_ms"],
            bound_ms=fleet["bound_ms"], bound_by=fleet["bound_by"], d23=timed[K2_D23[1]],
        ))
        w48 = wide[MS48_D]
        entries.append(dict(
            name=f"chol_inv_apply_resident_{name}", route="cuda", kernel_route="resident",
            source="piqp_tpu_torch/csrc/chol_inv_apply_resident.cu",
            replaces="piqp_tpu/ops/pallas_chol.py:270",
            launches=None, max_abs_err=worst_route["resident"], ms=w48["ms"],
            looped_ms=w48["looped_ms"], library_ms=w48["library_ms"],
            library_graph_ms=w48["library_graph_ms"], plain_ms=w48["plain_ms"],
            bound_ms=w48["bound_ms"], bound_by=w48["bound_by"], d64=wide[64],
        ))
        entries.append(dict(
            name=f"chol_inv_apply_split_{name}", route="cuda", kernel_route="split",
            source="piqp_tpu_torch/csrc/chol_inv_apply_product.cu",
            factor_source="piqp_tpu_torch/csrc/chol_inv_resident.cu" if factor == "resident"
            else "piqp_tpu_torch/csrc/signed_chol_inv_resident.cu",
            replaces="piqp_tpu/ops/pallas_chol.py:270",
            launches=None, max_abs_err=worst_route["split"], **sp_t,
        ))
    return entries


def _check_k3(torch, smi) -> list:
    """K3 against its plain version on the card, times at the fleet's
    shape."""
    from piqp_tpu_torch.ops import ldlt
    from piqp_tpu_torch.ops import signed_chol_inv as sci

    def routed(K, signs):
        """signed_cholesky_with_inverse, checked to launch the resident
        kernel with the cluster size the route names."""
        n = K.shape[-1]
        cluster = sci.cluster_size(n, K.dtype)
        if sci.kernel_route(n, K.dtype) != "resident":
            raise AssertionError(f"K3 n={n} {K.dtype} is not routed to the resident kernel")
        before = (dict(sci.launches_by_route), dict(sci.launches_by_cluster))
        L, Linv = sci.signed_cholesky_with_inverse(K, signs)
        grown = ({k: sci.launches_by_route[k] - before[0][k] for k in before[0]},
                 {k: sci.launches_by_cluster[k] - before[1][k] for k in before[1]})
        if grown != ({k: int(k == "resident") for k in before[0]},
                     {k: int(k == cluster) for k in before[1]}):
            raise AssertionError(f"K3 n={n} {K.dtype}: cluster {cluster}, launches {grown}")
        return cluster, L, Linv

    def check(name, K, signs, L, Linv, what) -> float:
        """L and Linv against the plain version; returns the worst error."""
        tol = K1_TOL[name]
        B, n = K.shape[0], K.shape[-1]
        torch.cuda.synchronize()
        L_ref, Linv_ref = sci.signed_chol_inv_reference(K, signs)
        eye = torch.eye(n, dtype=K.dtype, device="cuda")
        err_L = (L - L_ref).abs().max().item()
        err_Li = (Linv - Linv_ref).abs().max().item()
        err_I = (L @ Linv - eye).abs().max().item()
        err_K = ((L * signs) @ L.mT - K).abs().max().item()
        print(f"[K3 {name}] {what} B={B} n={n} ({int((signs > 0).sum())} positive): "
              f"|L-L_ref| {err_L:.3e} |Linv-Linv_ref| {err_Li:.3e} |L Linv - I| {err_I:.3e} "
              f"|L S L' - K| {err_K:.3e}")
        if not (err_L <= tol * max(1.0, L_ref.abs().max().item())
                and err_Li <= tol * Linv_ref.abs().max().item()
                and err_I <= 50 * tol
                and err_K <= 50 * tol * max(1.0, K.abs().max().item())):
            raise AssertionError(f"K3 {name} {what} B={B} n={n} disagrees with its plain version")
        if bool(torch.triu(L, 1).any()) or bool(torch.triu(Linv, 1).any()):
            raise AssertionError(f"K3 {name} {what} n={n}: nonzero upper triangle")
        return max(err_L, err_Li)

    entries = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        worst = 0.0
        for B, n in K3_SHAPES:
            K, signs = _quasidef_batch(torch, B, n, dtype, seed=n)
            cluster, L, Linv = routed(K, signs)
            worst = max(worst, check(name, K, signs, L, Linv, f"resident c={cluster}"))
        # a pivot of the wrong sign gives non-finite output for its problem
        # only, on a one-block and on a clustered shape
        for n in (40, 256):
            K, signs = _quasidef_batch(torch, 4, n, dtype, seed=1)
            j = int(torch.nonzero(signs > 0)[n // 3])
            K[2, j, j] = -1e3
            cluster, L, Linv = routed(K, signs)
            fin = (torch.isfinite(L).flatten(1).all(1) & torch.isfinite(Linv).flatten(1).all(1))
            print(f"[K3 {name}] resident c={cluster} n={n}: one wrong-sign pivot (row {j}) in "
                  f"problem 2 of 4, finite flags {fin.tolist()}")
            if fin.tolist() != [True, True, False, True]:
                raise AssertionError(f"K3 {name} n={n}: wrong-sign pivot gave finite flags "
                                     f"{fin.tolist()}")

        # the fleet's shape: the resident kernel, the blocked route and the
        # plain version
        B, n = K3_SHAPES[-1]
        K, signs = _quasidef_batch(torch, B, n, dtype, seed=7)
        cluster = sci.cluster_size(n, dtype)
        ms = _time_ms(torch, lambda: sci.signed_cholesky_with_inverse(K, signs))
        blocked_ms = _time_ms(torch, lambda: ldlt.blocked_inverse(K, signs), count=3, windows=1)
        plain_ms = _time_ms(torch, lambda: sci.signed_chol_inv_reference(K, signs),
                            count=3, windows=1)
        K64, signs64 = K[:LDLT_B64].contiguous(), signs
        cluster64, L, Linv = routed(K64, signs64)
        worst = max(worst, check(name, K64, signs64, L, Linv, f"resident c={cluster64}"))
        ms64 = _time_ms(torch, lambda: sci.signed_cholesky_with_inverse(K64, signs64))
        bound_ms, bound_by = _bound(name, (_factor_elements(B, n) + n) * K.element_size(),
                                    2 * B * n ** 3 / 3)
        bound64_ms, _ = _bound(name, (_factor_elements(LDLT_B64, n) + n) * K.element_size(),
                               2 * LDLT_B64 * n ** 3 / 3)
        print(f"[K3 {name}] B={B} n={n}: resident kernel (cluster {cluster}) {ms:.4f} ms, "
              f"blocked route {blocked_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms * 1e3:.1f} us ({bound_by}); blocked/resident {blocked_ms / ms:.2f}x; "
              f"no single library call computes L with K = L S L' (library_ms null); {smi}")
        print(f"[K3 {name}] B={LDLT_B64} n={n}: resident kernel {ms64:.4f} ms, bound "
              f"{bound64_ms * 1e3:.1f} us; {smi}")
        entries.append(dict(
            name=f"signed_chol_inv_{name}", route="cuda", kernel_route="resident",
            cluster=cluster, source="piqp_tpu_torch/csrc/signed_chol_inv_resident.cu",
            replaces="piqp_tpu/ops/pallas_chol.py:381",
            launches=None, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            blocked_ms=blocked_ms, ms_b64=ms64,
        ))
    return entries


def _stage_problem(ms, kw: dict, c=None) -> dict:
    """One multistage problem as the dense user-facing dict of
    ``_optimality`` (``to_dense`` of its stage blocks, on the host)."""
    d = ms.to_dense(ms.from_stage_blocks(**kw, device="cpu"))
    h = {k: getattr(d, k)[0].numpy() for k in ("P", "c", "A", "b", "G", "h_l", "h_u",
                                                "x_l", "x_u")}
    masks = {k: getattr(d, k)[0].numpy() for k in ("hl_mask", "hu_mask", "xl_mask", "xu_mask")}
    return dict(
        P=h["P"], c=h["c"] if c is None else c, A=h["A"], b=h["b"], G=h["G"],
        h_l=np.where(masks["hl_mask"], h["h_l"], -np.inf),
        h_u=np.where(masks["hu_mask"], h["h_u"], np.inf),
        x_l=np.where(masks["xl_mask"], h["x_l"], -np.inf),
        x_u=np.where(masks["xu_mask"], h["x_u"], np.inf),
    )


def _stage_problem_sparse(kw: dict, c=None) -> dict:
    """One multistage problem as ``_optimality``'s dict, with P (full,
    symmetric), A and G as scipy.sparse matrices assembled from its stage
    blocks in ``multistage.to_dense``'s layout: for stages too wide to
    densify a fleet of."""
    import scipy.sparse as sp

    Pd, Psub, Pa, Pc = kw["Pd"], kw["Psub"], kw["Pa"], kw["Pc"]
    T, D, _ = Pd.shape
    Da = Pc.shape[0]
    n = T * D + Da
    t = np.arange(T) * D
    g = np.full(T, T * D)

    def assemble(blocks, shape):
        """A CSR matrix from (row offsets, column offsets, (k, a, b) blocks)."""
        rows, cols, vals = [], [], []
        for r0, c0, M in blocks:
            k, a, b = M.shape
            rows.append(np.broadcast_to(np.asarray(r0)[:, None, None]
                                        + np.arange(a)[None, :, None], M.shape).ravel())
            cols.append(np.broadcast_to(np.asarray(c0)[:, None, None]
                                        + np.arange(b)[None, None, :], M.shape).ravel())
            vals.append(M.ravel())
        return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                             shape=shape)

    P = assemble([(t, t, Pd), (t[:-1] + D, t[:-1], Psub[:-1]),
                  (t[:-1], t[:-1] + D, Psub[:-1].transpose(0, 2, 1)),
                  (g, t, Pa), (t, g, Pa.transpose(0, 2, 1)), ([T * D], [T * D], Pc[None])],
                 (n, n))

    def constraints(M1, M2, Mg):
        r = M1.shape[1]
        rows = np.arange(T) * r
        return assemble([(rows, t, M1), (rows[:-1], t[1:], M2[:-1]), (rows, g, Mg)], (T * r, n))

    return dict(P=P, c=kw["c"] if c is None else c, A=constraints(kw["A1"], kw["A2"], kw["Ag"]),
                b=kw["b"], G=constraints(kw["G1"], kw["G2"], kw["Gg"]), h_l=kw["h_l"],
                h_u=kw["h_u"], x_l=np.full(n, -np.inf), x_u=np.full(n, np.inf))


def _timed(torch, fn, dev="cuda"):
    _sync(torch, dev)
    t = time.perf_counter()
    out = fn()
    _sync(torch, dev)
    return out, time.perf_counter() - t


def _profile_round(torch, label, fn, unprofiled_s, smi, kernel_names=()):
    """Kernel time by name and device busy share of one round."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # kernel events only: an aten op's row repeats the time of its kernels
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    ours = {k: sum(e.self_device_time_total for e in rows if k in e.key) for k in kernel_names}
    share = f", {' / '.join(kernel_names)} {100 * sum(ours.values()) / max(busy_us, 1e-9):.1f}% " \
        f"of it" if kernel_names else ""
    if len(kernel_names) > 1:
        share += " (" + ", ".join(f"{k} {100 * v / max(busy_us, 1e-9):.1f}%"
                                  for k, v in ours.items()) + ")"
    print(f"[profile {label}] kernel time {busy_us / 1e3:.1f} ms in {launches} launches of "
          f"{len(rows)} kernels{share}; device busy {100 * busy_us / (unprofiled_s * 1e6):.1f}% "
          f"of the unprofiled round ({unprofiled_s * 1e3:.1f} ms), "
          f"{100 * busy_us / wall_us:.1f}% of the profiled one ({wall_us / 1e3:.1f} ms); {smi}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile {label}]   {e.self_device_time_total / 1e3:9.3f} ms  "
              f"{e.count:6d} launches  {e.key[:80]}")


def _sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _nondegenerate_qp(n, p, m, seed, active=DIFF_ACTIVE, boxes=DIFF_BOXES):
    """A QP with a planted, strictly complementary, nondegenerate active
    set, built by inverse KKT as tests/test_diff.py builds its problems:
    x*, y*, the duals and the active constraints are chosen and c is
    backed out.  ``active`` rows of G sit at their upper bound and as many
    at their lower one, the rest have two loose bounds; ``boxes`` boxes
    are active above, as many below, and as many are loose.  Returns the
    problem and x*."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    P = M @ M.T + n * np.eye(n)
    A = rng.standard_normal((p, n))
    G = rng.standard_normal((m, n))
    xs = rng.standard_normal(n)
    ys = rng.standard_normal(p)
    Gx = G @ xs
    h_l, h_u = Gx - 1.0, Gx + 1.0
    z_l, z_u = np.zeros(m), np.zeros(m)
    up, lo = slice(0, active), slice(active, 2 * active)
    h_l[up], h_u[up], z_u[up] = -np.inf, Gx[up], rng.uniform(0.5, 1.5, active)
    h_l[lo], h_u[lo], z_l[lo] = Gx[lo], np.inf, rng.uniform(0.5, 1.5, active)
    x_l, x_u = np.full(n, -np.inf), np.full(n, np.inf)
    z_bl, z_bu = np.zeros(n), np.zeros(n)
    up, lo, loose = slice(0, boxes), slice(boxes, 2 * boxes), slice(2 * boxes, 3 * boxes)
    x_u[up], z_bu[up] = xs[up], rng.uniform(0.5, 1.5, boxes)
    x_l[lo], z_bl[lo] = xs[lo], rng.uniform(0.5, 1.5, boxes)
    x_l[loose], x_u[loose] = xs[loose] - 2.0, xs[loose] + 2.0
    c = -(P @ xs + A.T @ ys + G.T @ (z_u - z_l) + z_bu - z_bl)
    return dict(P=P, c=c, A=A, b=A @ xs, G=G, h_l=h_l, h_u=h_u, x_l=x_l, x_u=x_u), xs


def _diff_grads(torch, data, settings, loss_of, fields, dev):
    """solve_qp_diff of ``data`` and the backward pass of
    ``loss_of(w).sum()``: (w, gradients by field, forward s, backward s,
    K1 and K2 launches by route in the forward, K2's in the backward)."""
    import dataclasses

    from piqp_tpu_torch import solve_qp_diff
    from piqp_tpu_torch.ops import chol_inv

    leaves = {k: getattr(data, k).detach().clone().requires_grad_() for k in fields}
    _reset_counts()
    _sync(torch, dev)
    t = time.perf_counter()
    w = solve_qp_diff(dataclasses.replace(data, **leaves), settings, True)
    _sync(torch, dev)
    fwd_s = time.perf_counter() - t
    fwd = (dict(chol_inv.launches_by_route), dict(chol_inv.apply_launches_by_route))
    _reset_counts()
    t = time.perf_counter()
    loss_of(w).sum().backward()
    _sync(torch, dev)
    bwd_s = time.perf_counter() - t
    bwd = dict(chol_inv.apply_launches_by_route)
    return w, {k: v.grad for k, v in leaves.items()}, fwd_s, bwd_s, fwd, bwd


def _fd_check(torch, label, data, settings, loss_of, grads, directions, rel) -> None:
    """Central differences (step 1e-6) of the per-problem loss along each
    direction against the gradients, for every problem of ``data``: |fd -
    g.D| <= max(rel |g.D|, FD_ABS)."""
    import dataclasses

    from piqp_tpu_torch import solve_qp_diff

    eps = 1e-6
    for field, D in directions.items():
        f = getattr(data, field)
        with torch.no_grad():
            up = loss_of(solve_qp_diff(dataclasses.replace(data, **{field: f + eps * D}),
                                       settings, True))
            dn = loss_of(solve_qp_diff(dataclasses.replace(data, **{field: f - eps * D}),
                                       settings, True))
        num = ((up - dn) / (2 * eps)).cpu().numpy()
        ana = (grads[field][:D.shape[0]] * D).flatten(1).sum(1).cpu().numpy()
        err = np.abs(num - ana)
        print(f"[{label}] finite differences along {field}: analytic "
              f"{np.array2string(ana, precision=6)}, central {np.array2string(num, precision=6)}")
        if not np.all(err <= np.maximum(rel * np.abs(ana), FD_ABS)):
            raise AssertionError(f"{label}: gradient in {field} disagrees with central "
                                 f"differences ({err.max():.3e})")


def _grad_xcheck(label, grads, cpu_grads) -> None:
    """Gradients of the first problems on the card against the port on the
    CPU, each field relative to its largest entry."""
    worst = 0.0
    for k, g in cpu_grads.items():
        err = (grads[k][:g.shape[0]].cpu() - g).abs().max().item()
        rel = err / max(g.abs().max().item(), 1e-300)
        worst = max(worst, rel)
        if not rel <= GRAD_XCHECK_REL:
            raise AssertionError(f"{label}: gradient in {k} on the card differs from the CPU "
                                 f"by {rel:.3e} of its largest entry")
    print(f"[{label}] gradients of problems 0-{g.shape[0] - 1} on the card against the CPU: "
          f"worst relative difference {worst:.3e} (limit {GRAD_XCHECK_REL:.0e}) in "
          f"{', '.join(cpu_grads)}")


def _diff_dense_fleet(torch, smi, B=DIFF_B, dev="cuda") -> dict:
    """Phase 10: solve_qp_diff on B planted QPs at the main path's width
    and the backward pass of sum(v . x); returns times and launches."""
    import dataclasses

    from piqp_tpu_torch import Settings, prepare_batch, solve_batch
    from piqp_tpu_torch.types import index, to_device

    tight = Settings(**DIFF_TIGHT)
    made = [_nondegenerate_qp(MAIN_N, MAIN_P, MAIN_M, seed=3000 + i) for i in range(B)]
    probs = [prob for prob, _ in made]
    data = prepare_batch(probs, device=dev)
    v = torch.as_tensor(np.random.default_rng(3100).standard_normal((B, MAIN_N)), device=dev)

    def loss_of(w):
        return (v[:w.x.shape[0]].to(w.x.device) * w.x).sum(-1)

    fields = ("P", "c", "A", "b", "G", "h_l", "h_u", "x_l", "x_u")
    w, g, fwd_s, bwd_s, (k1, _), _ = _diff_grads(torch, data, tight, loss_of, fields, dev)
    ref = solve_batch(data, dataclasses.replace(tight, refine_mu_factor=0.0))
    viol = _check_round(probs, ref, "dense differentiable forward")
    dx = (w.x - ref.x).abs().max().item()
    dxs = max(np.abs(w.x[i].detach().cpu().numpy() - xs).max() for i, (_, xs) in enumerate(made))
    print(f"[diff dense] B={B} n={MAIN_N} p={MAIN_P} m={MAIN_M} ({2 * DIFF_ACTIVE} active rows, "
          f"{2 * DIFF_BOXES} active boxes a problem), float64 eps_abs="
          f"{DIFF_TIGHT['eps_abs']:.0e}: {B}/{B} SOLVED, worst KKT {viol:.2e}, |x - x_solve| "
          f"{dx:.2e}, |x - x*| {dxs:.2e}, iterations max {int(ref.info.iter.max())}")
    if not (dx <= 1e-9 and dxs <= 1e-6):
        raise AssertionError("the differentiable forward disagrees with the solve or x*")
    rng = np.random.default_rng(3200)
    sub = index(data, slice(0, 4))
    M = rng.standard_normal((4, MAIN_N, MAIN_N))
    dirs = {"c": rng.standard_normal((4, MAIN_N)), "b": rng.standard_normal((4, MAIN_P)),
            "h_u": rng.standard_normal((4, MAIN_M)) * sub.hu_mask.cpu().numpy(),
            "P": M + M.transpose(0, 2, 1)}
    _fd_check(torch, "diff dense", sub, tight, loss_of, g,
                   {k: torch.as_tensor(D, device=dev) for k, D in dirs.items()}, FD_REL)
    _, gc, *_ = _diff_grads(torch, to_device(sub, "cpu"), tight, loss_of, fields, "cpu")
    _grad_xcheck("diff dense", g, gc)
    print(f"[diff dense] B={B}: forward {fwd_s * 1e3:.1f} ms, backward {bwd_s * 1e3:.1f} ms "
          f"(host clock, synchronized), K1 launches in the forward by route {k1}; {smi}")
    return k1


def _diff_stage_fleet(torch, smi, data, dev="cuda") -> dict:
    """Phase 11: solve_qp_diff on a stage fleet and the backward pass of
    sum(x^2) in c and Pd; returns times and launches."""
    import dataclasses

    from piqp_tpu_torch import Settings, solve_batch
    from piqp_tpu_torch.types import index, to_device

    tight = Settings(**DIFF_TIGHT)
    B = data.B

    def loss_of(w):
        return (w.x ** 2).sum(-1)

    fields = ("c", "Pd")
    w, g, fwd_s, bwd_s, (_, k2f), k2b = _diff_grads(torch, data, tight, loss_of, fields, dev)
    ref = solve_batch(data, dataclasses.replace(tight, refine_mu_factor=0.0))
    status = ref.info.status.cpu()
    dx = (w.x - ref.x).abs().max().item()
    print(f"[diff stage] B={B} T={data.T} D={data.D} (n={data.n}), float64 eps_abs="
          f"{DIFF_TIGHT['eps_abs']:.0e}: {int((status == 1).sum())}/{B} SOLVED, |x - x_solve| "
          f"{dx:.2e}, iterations max {int(ref.info.iter.max())}")
    if not (bool((status == 1).all()) and dx <= 1e-9):
        raise AssertionError("the stage differentiable forward did not solve every problem")
    rng = np.random.default_rng(3300)
    sub = index(data, slice(0, 4))
    Draw = rng.standard_normal(tuple(sub.Pd.shape))
    dirs = {"c": rng.standard_normal(tuple(sub.c.shape)),
            "Pd": (Draw + np.swapaxes(Draw, -1, -2)) / 2}
    _fd_check(torch, "diff stage", sub, tight, loss_of, g,
                   {k: torch.as_tensor(D, device=dev) for k, D in dirs.items()}, FD_STAGE_REL)
    _, gc, *_ = _diff_grads(torch, to_device(sub, "cpu"), tight, loss_of, fields, "cpu")
    _grad_xcheck("diff stage", g, gc)
    print(f"[diff stage] B={B}: forward {fwd_s * 1e3:.1f} ms, backward {bwd_s * 1e3:.1f} ms "
          f"(host clock, synchronized); K2 launches by route in the forward {k2f}, in the "
          f"backward alone {k2b}; {smi}")
    return k2b


def _sqp_and_compaction(torch, smi, problems, moved, data, data_w, cold, warm_pt, settings):
    """Phase 12: SQP rounds against sequential warm rounds, compaction
    against the one-pass warm round, on the main path's fleet."""
    import dataclasses

    from piqp_tpu_torch import (
        solve_batch, solve_batch_compact, solve_batch_sqp, warm_from_result,
    )
    from piqp_tpu_torch.ops import chol_inv

    B = data.B
    _reset_counts()
    (wf, st, it), sqp_s = _timed(torch, lambda: solve_batch_sqp(
        data, settings, rounds=SQP_ROUNDS, warm=cold))
    k1 = dict(chol_inv.launches_by_route)
    if not bool((st == 1).all()):
        raise AssertionError(f"SQP rounds: statuses {st[st != 1][:5].tolist()} not SOLVED")
    scale = 1.0 + 0.01 * SQP_ROUNDS
    last = [dict(p, c=p["c"] * scale) for p in problems]
    host = {k: getattr(wf, k).double().cpu().numpy()
            for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu")}
    viol = max(_optimality(prob, *(host[k][i] for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu")))
               for i, prob in enumerate(last))
    if not viol <= OPT_TOL:
        raise AssertionError(f"SQP last round: KKT violation {viol:.3e}")

    def sequential():
        w = warm_from_result(cold)
        for r in range(SQP_ROUNDS):
            res = solve_batch(dataclasses.replace(data, c=data.c * (1.0 + 0.01 * (r + 1))),
                              settings, warm=w)
            w = warm_from_result(res)
        return w

    seq, seq_s = _timed(torch, sequential)
    dx = (wf.x - seq.x).abs().max().item()
    its = it.cpu().numpy()
    print(f"[sqp] B={B} {SQP_ROUNDS} rounds, all SOLVED, last round worst KKT {viol:.2e}, "
          f"iterations per round median {np.median(its, axis=0).tolist()} max "
          f"{its.max(axis=0).tolist()}, |x - x_sequential| {dx:.2e} (limit "
          f"{XCHECK_MIXED_TOL:.0e}), K1 launches by route {k1}")
    print(f"[sqp] B={B}: solve_batch_sqp {sqp_s * 1e3 / SQP_ROUNDS:.1f} ms a round, sequential "
          f"solve_batch rounds {seq_s * 1e3 / SQP_ROUNDS:.1f} ms a round (host clock); {smi}")
    if not dx <= XCHECK_MIXED_TOL:
        raise AssertionError("SQP rounds disagree with sequential warm rounds")

    one, one_s = _timed(torch, lambda: solve_batch(data_w, settings, warm=warm_pt))
    _reset_counts()
    rc, rc_s = _timed(torch, lambda: solve_batch_compact(data_w, settings, warm=cold,
                                                         phase1_iters=4))
    k1c = dict(chol_inv.launches_by_route)
    if rc.info.status.tolist() != one.info.status.tolist():
        raise AssertionError("compaction statuses differ from the one-pass warm round")
    viol_c = _check_round(moved, rc, "compaction")
    it1, itc = one.info.iter.cpu().numpy(), rc.info.iter.cpu().numpy()
    stalled = itc > 4
    eff = (4 * B + int(stalled.sum()) * int((itc[stalled] - 4).max(initial=0))) / B
    print(f"[compact] B={B} warm, phase 1 of 4 iterations: {int(stalled.sum())} stragglers "
          f"re-solved, all SOLVED, worst KKT {viol_c:.2e}, K1 launches by route {k1c}; "
          f"iterations per problem mean {itc.mean():.2f} (one pass {it1.mean():.2f}), "
          f"lockstep iterations per problem {eff:.2f} (one pass {it1.max()})")
    print(f"[compact] B={B}: solve_batch_compact {rc_s * 1e3:.1f} ms, one-pass warm round "
          f"{one_s * 1e3:.1f} ms (host clock); {smi}")
    # the budget the JAX package's docstring recommends for a repeated
    # workload: the one pass's 95th percentile of iterations, plus one
    tuned = int(np.percentile(it1, 95)) + 1
    rt, rt_s = _timed(torch, lambda: solve_batch_compact(data_w, settings, warm=cold,
                                                         phase1_iters=tuned))
    if rt.info.status.tolist() != one.info.status.tolist():
        raise AssertionError("tuned compaction statuses differ from the one-pass warm round")
    _check_round(moved, rt, "tuned compaction")
    itt = rt.info.iter.cpu().numpy()
    k = int((itt > tuned).sum())
    eff_t = (tuned * B + k * int((itt[itt > tuned] - tuned).max(initial=0))) / B
    print(f"[compact] B={B} phase 1 of {tuned} iterations (95th percentile + 1): {k} stragglers, "
          f"all SOLVED, lockstep iterations per problem {eff_t:.2f}, {rt_s * 1e3:.1f} ms "
          f"(host clock); {smi}")
    return dict(k1_sqp=k1, k1_compact=k1c)


def _timings_and_host_route(torch, smi, problems, moved):
    """Phase 13: compute_timings on a DenseSolver on the card, and the
    host sparse route against the card's dense solve."""
    from piqp_tpu_torch import (
        DenseSolver, KKTBackend, Settings, SparseSolver, Status, solve_dense,
    )
    from piqp_tpu_torch.utils.random import sparse_strongly_convex_qp

    ds = DenseSolver(Settings(compute_timings=True), device="cuda")
    ds.setup(**problems[0])
    if ds.solve() != Status.SOLVED:
        raise AssertionError("DenseSolver with compute_timings did not solve")
    ds.update(c=moved[0]["c"])
    if ds.solve(warm_start=True) != Status.SOLVED:
        raise AssertionError("DenseSolver with compute_timings did not solve the update")
    names = ("setup_time", "update_time", "solve_time", "kkt_factor_time", "kkt_solve_time",
             "run_time")
    t = {k: float(getattr(ds.result.info, k)) for k in names}
    print(f"[timings] DenseSolver(compute_timings=True) n={MAIN_N} warm solve: "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in t.items()) + f"; {smi}")
    if not (all(v > 0 for v in t.values()) and t["run_time"] >= t["solve_time"]):
        raise AssertionError(f"compute_timings left a time field empty: {t}")

    prob = sparse_strongly_convex_qp(600, 60, 120, seed=600)
    ss = SparseSolver(Settings(kkt_solver=KKTBackend.sparse_host), device="cuda")
    ss.setup(**prob)
    (status, host_s) = _timed(torch, ss.solve)
    if status != Status.SOLVED or ss._host_raw is None:
        raise AssertionError("SparseSolver(sparse_host) did not solve on the host route")
    dense = {k: (v.toarray() if hasattr(v, "toarray") else v) for k, v in prob.items()}
    ref, dev_s = _timed(torch, lambda: solve_dense(**dense, device="cuda"))
    x_ref = ref.x.cpu().numpy()
    dx = float(np.abs(ss.result.x - x_ref).max()) / max(1.0, float(np.abs(x_ref).max()))
    print(f"[host] SparseSolver(sparse_host) n=600 p=60 m=120: SOLVED in "
          f"{ss.result.info.iter} iterations, {host_s * 1e3:.1f} ms on the host "
          f"(kkt factor {ss.result.info.kkt_factor_time * 1e3:.1f} ms); dense solve on the card "
          f"{int(ref.info.iter)} iterations, {dev_s * 1e3:.1f} ms; |x_host - x_card| {dx:.2e} "
          f"(limit 1e-6); {smi}")
    if not (int(ref.info.status) == 1 and dx <= 1e-6):
        raise AssertionError("the host route disagrees with the card's dense solve")


def _unpad_stage(res, T, T_pad, D, Da, ra, rg, i=0) -> dict:
    """The float64 host arrays of problem i of a result in a padded stage
    layout (``res``'s fields, or a dict of them on the host), cut back to
    the unpadded problem's coordinates and rows."""
    def xlike(v):
        return np.concatenate([v[:T * D], v[T_pad * D:]])

    h = {}
    for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu"):
        v = (res[k] if isinstance(res, dict) else getattr(res, k))[i]
        h[k] = v.double().cpu().numpy() if hasattr(v, "cpu") else np.asarray(v, np.float64)
    return dict(x=xlike(h["x"]), y=h["y"][:T * ra], z_l=h["z_l"][:T * rg],
                z_u=h["z_u"][:T * rg], z_bl=xlike(h["z_bl"]), z_bu=xlike(h["z_bu"]))


# phase 14's multi-rank part: the ranks meet through a FileStore on gloo
# (NCCL refuses two ranks of one communicator on one device)
HZ_RANK_TIMEOUT_S = 600
HZ_FLEET = dict(B=MS48_B, T=MS48_T, D=MS48_D, Da=MS48_DA, ra=4, rg=4, seed0=4000)


def _cfg4_problems() -> dict:
    """Config 4 and its c *= 1.01 warm re-solve as ``_optimality``'s host
    problems."""
    from piqp_tpu_torch import multistage

    kw = multistage.random_multistage_arrays(seed=CFG4_SEED, T=MS_T, D=MS_D, Da=MS_DA,
                                             ra=MS_RA, rg=MS_RG)
    return {"cold": _stage_problem(multistage, kw),
            "warm": _stage_problem(multistage, kw, kw["c"] * 1.01)}


def _hz_runs(torch, group) -> dict:
    """The horizon-sharded runs of one rank of ``group``, at HZ_CHUNKS
    chunks, each handed over on the CPU and placed by ``shard_horizon(...,
    device="cuda")``: config 4 float64 and mixed, cold and a warm re-solve
    after c *= 1.01, then the phase-17 fleet (128 problems, T = 41 padded
    to 44, D = 48) float64 cold.  Per run: the result on the host, status,
    iterations, seconds (host clock), the stage-block bytes this rank
    holds (its nine block fields, and their float32 copy ``data32`` under
    mixed precision), the peak device memory above the allocation at its
    start (``max_memory_allocated`` after a reset), the collectives by
    kind and K2's launches by dtype and route, and the K2 shapes
    launched."""
    import dataclasses

    from piqp_tpu_torch import Settings, kkt, multistage
    from piqp_tpu_torch.ops import chol_inv
    from piqp_tpu_torch.parallel import comm, shard_horizon, solve_horizon_sharded

    shapes, kernel = set(), multistage.cholesky_inverse_apply

    def recorded(K, RHS):
        if K.is_cuda:
            shapes.add((str(K.dtype).removeprefix("torch."), K.shape[0], K.shape[-1],
                        RHS.shape[-1]))
        return kernel(K, RHS)

    runs = {}

    def run(label, data, settings, warm=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        counts = (dict(comm.collective_calls), dict(chol_inv.apply_launches_by_dtype),
                  dict(chol_inv.apply_launches_by_route))
        t = time.perf_counter()
        sdata = shard_horizon(data, group, HZ_CHUNKS, device="cuda")
        res = solve_horizon_sharded(sdata, settings=settings, warm=warm)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        held = [sdata] + ([kkt.precompute(sdata, True)["data32"]]
                          if settings.mixed_precision else [])
        runs[label] = dict(
            {k: getattr(res, k).cpu().numpy() for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu")},
            status=res.info.status.cpu().numpy(), iter=res.info.iter.cpu().numpy(),
            seconds=secs, peak=torch.cuda.max_memory_allocated() - base,
            block_bytes=sum(getattr(d, k).nbytes for d in held for k in multistage.STAGE_BLOCKS),
            stages=sdata.stages, horizon=sdata.T,
            collectives={k: comm.collective_calls[k] - counts[0][k] for k in counts[0]},
            k2_dtype={k: chol_inv.apply_launches_by_dtype[k] - counts[1][k] for k in counts[1]},
            k2_route={k: chol_inv.apply_launches_by_route[k] - counts[2][k] for k in counts[2]})
        return res

    dims = dict(T=MS_T, D=MS_D, Da=MS_DA, ra=MS_RA, rg=MS_RG)
    base = multistage.random_multistage_qp(seed=CFG4_SEED, **dims, device="cpu")
    moved = dataclasses.replace(base, c=base.c * 1.01)
    multistage.cholesky_inverse_apply = recorded
    try:
        for label, st in (("float64", Settings()), ("mixed", Settings(mixed_precision=True))):
            cold = run(f"config 4 {label} cold", base, st)
            run(f"config 4 {label} warm", moved, st, warm=cold)
    finally:
        multistage.cholesky_inverse_apply = kernel
    f = HZ_FLEET
    fleet = multistage.random_multistage_batch(
        [f["seed0"] + i for i in range(f["B"])], T=f["T"], D=f["D"], Da=f["Da"], ra=f["ra"],
        rg=f["rg"], device="cpu")
    run("fleet float64 cold", fleet, Settings())
    runs["k2_shapes"] = sorted(shapes)
    return runs


def _hz_rank(rank: int, world: int, store: str, out: str) -> None:
    """One spawned rank of phase 14's multi-rank part: the device first,
    then a gloo group of ``world`` ranks met through the FileStore
    ``store``, ``_hz_runs``, and its runs pickled to out/rank<r>.pkl."""
    import os
    import pickle

    import torch

    torch.cuda.set_device(0)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        runs = _hz_runs(torch, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(runs, fh)


def _hz_spawn(world: int) -> list:
    """``_hz_rank`` on ``world`` spawned ranks sharing the one card; each
    rank's runs, in rank order.  Raises if a rank fails or the ranks
    outlast HZ_RANK_TIMEOUT_S (the ranks are killed)."""
    import os
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_hz_rank, args=(world, os.path.join(tmp, "store"), tmp),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + HZ_RANK_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise AssertionError(f"{world} ranks did not finish in "
                                         f"{HZ_RANK_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                ranks.append(pickle.load(fh))
    return ranks


def _hz_check_reference(ref: dict, smi) -> None:
    """The one-rank runs of ``_hz_runs`` on the NCCL group: every problem
    SOLVED and optimal on the host, K2's small kernel launched in every
    config-4 run."""
    from piqp_tpu_torch import multistage

    probs = _cfg4_problems()
    dims = dict(T=MS_T, D=MS_D, Da=MS_DA, ra=MS_RA, rg=MS_RG)
    f = HZ_FLEET
    fdims = dict(T=f["T"], D=f["D"], Da=f["Da"], ra=f["ra"], rg=f["rg"])
    fleet = [_stage_problem_sparse(multistage.random_multistage_arrays(seed=f["seed0"] + i,
                                                                       **fdims))
             for i in range(f["B"])]
    for label, run in ref.items():
        if label == "k2_shapes":
            continue
        if label.startswith("config 4"):
            cases, d = [probs[label.split()[-1]]], dims
            if run["k2_route"]["small"] == 0:
                raise AssertionError(f"[horizon ranks] one rank, {label}: no small K2 launch")
        else:
            cases, d = fleet, fdims
        worst = max(_optimality(prob, *(
            _unpad_stage(run, d["T"], run["horizon"], d["D"], d["Da"], d["ra"], d["rg"], i)[k]
            for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu"))) for i, prob in enumerate(cases))
        print(f"[horizon ranks] world=1 (NCCL) {label}: {len(cases)}/{len(cases)} SOLVED "
              f"{bool((run['status'] == 1).all())}, worst KKT {worst:.2e}")
        if not ((run["status"] == 1).all() and worst <= OPT_TOL):
            raise AssertionError(f"[horizon ranks] one rank, {label}: status or KKT")


def _hz_ranks_phase(torch, smi, ref: dict) -> dict:
    """Phase 14's multi-rank part: ``_hz_runs`` on 2 and 4 gloo ranks
    spawned on the one card, against the one-rank NCCL runs ``ref``.
    Every rank's x identical to the others'; float64 status and
    iterations equal to one rank's and x within XCHECK_F64_TOL of it; the
    mixed runs SOLVED, optimal on the host and within XCHECK_MIXED_TOL of
    one rank's mixed x; each rank's stage-block bytes exactly its stages'
    share of one rank's; K2's small kernel launched in every rank's config-4
    runs, at shapes phase 2b held against the plain version; the fleet's
    peak memory falling from 1 to 2 to 4 ranks.  Returns each world's K2
    launches by dtype, per rank."""
    probs = _cfg4_problems()
    checked = {(name, *shape) for name in ("float32", "float64") for shape in K2_SHAPES}
    labels = [k for k in ref if k != "k2_shapes"]
    peaks = {1: [ref["fleet float64 cold"]["peak"]]}
    k2_by_world = {}
    for label in labels:
        run = ref[label]
        print(f"[horizon ranks] world=1 {label}: stages {run['stages']} of {run['horizon']}, "
              f"stage blocks {run['block_bytes']} B, peak {run['peak']} B above the start, "
              f"{run['seconds'] * 1e3:.1f} ms (host clock), iterations "
              f"{int(np.max(run['iter']))} max, collectives {run['collectives']}, K2 by route "
              f"{run['k2_route']}; {smi}")
    for world in HZ_WORLDS:
        t0 = time.perf_counter()
        ranks = _hz_spawn(world)
        spawn_s = time.perf_counter() - t0
        k2_by_world[world] = []
        for label in labels:
            want = ref[label]
            mixed = "mixed" in label
            for r, got in enumerate(ranks):
                run = got[label]
                what = f"world={world} rank {r} {label}"
                per = want["horizon"] // world
                same = np.array_equal(run["x"], ranks[0][label]["x"])
                dx = float(np.abs(run["x"] - want["x"]).max())
                tol = XCHECK_MIXED_TOL if mixed else XCHECK_F64_TOL
                share = run["block_bytes"] * world == want["block_bytes"]
                ok = (same and dx <= tol and share and (run["status"] == 1).all()
                      and tuple(run["stages"]) == (r * per, (r + 1) * per)
                      and (mixed or np.array_equal(run["iter"], want["iter"])))
                viol = None
                if mixed:
                    host = _unpad_stage(run, MS_T, run["horizon"], MS_D, MS_DA, MS_RA, MS_RG)
                    viol = _optimality(probs[label.split()[-1]], *(host[k] for k in (
                        "x", "y", "z_l", "z_u", "z_bl", "z_bu")))
                    ok = ok and viol <= OPT_TOL
                print(f"[horizon ranks] {what}: stages {tuple(run['stages'])} of "
                      f"{run['horizon']}, stage blocks {run['block_bytes']} B (one rank "
                      f"{want['block_bytes']} B, share exact {share}), peak {run['peak']} B "
                      f"above the start, {run['seconds'] * 1e3:.1f} ms (host clock), "
                      f"iterations {int(np.max(run['iter']))} max (one rank "
                      f"{int(np.max(want['iter']))}), x identical to rank 0 {same}, |x - "
                      f"x_one_rank| {dx:.2e} (limit {tol:.0e})"
                      + (f", KKT {viol:.2e}" if viol is not None else "")
                      + f", collectives {run['collectives']}, K2 by route {run['k2_route']}; "
                      f"{smi}")
                if not ok:
                    raise AssertionError(f"[horizon ranks] {what} disagrees with one rank")
        for r, got in enumerate(ranks):
            cfg4 = [got[k] for k in labels if k.startswith("config 4")]
            small = [run["k2_route"]["small"] for run in cfg4]
            other = sum(run["k2_route"][k] for run in cfg4 for k in ("resident", "split"))
            shapes = set(got["k2_shapes"])
            print(f"[horizon ranks] world={world} rank {r}: K2 small launches in each config-4 "
                  f"run {small}, resident + split {other}; K2 shapes (dtype, N, n, R) "
                  f"{sorted(shapes)}, all held against the plain version in phase 2b "
                  f"{shapes <= checked}")
            if not (min(small) > 0 and other == 0 and shapes <= checked):
                raise AssertionError(f"[horizon ranks] world={world} rank {r}: K2 launches "
                                     f"{small} small, {other} other, shapes unchecked "
                                     f"{sorted(shapes - checked)}")
            k2_by_world[world].append({k: sum(run["k2_dtype"][k] for run in cfg4)
                                       for k in ("float32", "float64")})
        peaks[world] = [got["fleet float64 cold"]["peak"] for got in ranks]
        print(f"[horizon ranks] world={world}: {world} spawned gloo ranks on one card in "
              f"{spawn_s:.1f} s (start-up included), fleet peak per rank {peaks[world]} B; "
              f"ranks share one card, so no speed-up across GPUs is shown or claimed")
    falls = max(peaks[2]) < peaks[1][0] and max(peaks[4]) < min(peaks[2])
    print(f"[horizon ranks] fleet peak memory per rank (B above the start), 1 / 2 / 4 ranks: "
          f"{peaks[1]} / {peaks[2]} / {peaks[4]}, falling {falls}; {smi}")
    if not falls:
        raise AssertionError("[horizon ranks] the fleet's peak memory does not fall with the "
                             "group's size")
    return k2_by_world


def _horizon_phase(torch, smi, fleet: dict, dense: dict) -> dict:
    """Phase 14: horizon-sharded multistage solves and batch sharding on a
    NCCL process group of one rank (a gloo group beside it for the CPU
    cross-check).  BASELINE config 4 (one problem, T = 100, D = 8) at 4
    chunks (cyclic-reduction interiors through K2) and 8 chunks (T pads to
    104, chain interiors), float64 and mixed, cold and a warm re-solve
    after c *= 1.01; the phase-7 fleet at 4 chunks; ``solve_batch`` with
    ``sharding`` on the phase-3 fleet; then ``_hz_runs`` on the one rank,
    the reference of ``_hz_ranks_phase`` on 2 and 4 ranks.  Returns the
    phase's K2 launches by dtype, the batch solve's K1 launches by route
    and the multi-rank part's K2 launches by dtype per rank."""
    import dataclasses
    import os
    import tempfile

    import torch.distributed as dist

    from piqp_tpu_torch import Settings, multistage, solve_batch, solve_horizon_sharded
    from piqp_tpu_torch.ops import chol_inv
    from piqp_tpu_torch.parallel import sharded_calls
    from piqp_tpu_torch.types import index, to_device

    # the shapes of the sharded solves' K2 launches on the card, each to be
    # one that phase 2 held against the plain version
    launched, kernel = set(), multistage.cholesky_inverse_apply

    def recorded(K, RHS):
        if K.is_cuda:
            launched.add((str(K.dtype).removeprefix("torch."), K.shape[0], K.shape[-1],
                          RHS.shape[-1]))
        return kernel(K, RHS)

    dims = dict(T=MS_T, D=MS_D, Da=MS_DA, ra=MS_RA, rg=MS_RG)
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
                                rank=0, world_size=1)
        try:
            gloo = dist.new_group(backend="gloo")
            dist.all_reduce(torch.zeros(1, device="cuda"))  # the communicator, set up once
            f64, mixed = Settings(), Settings(mixed_precision=True)
            kw = multistage.random_multistage_arrays(seed=CFG4_SEED, **dims)
            base = multistage.random_multistage_qp(seed=CFG4_SEED, **dims)
            moved = dataclasses.replace(base, c=base.c * 1.01)
            probs = {"cold": _stage_problem(multistage, kw),
                     "warm": _stage_problem(multistage, kw, kw["c"] * 1.01)}
            # the sequential solves on the card: cold, then warm from its own
            # cold result, as the sharded runs below (a warm re-solve stops
            # at its own point within the tolerances, up to ~1e-4 from the
            # cold optimum of the moved problem)
            seq = {}
            for label, st in (("float64", f64), ("mixed", mixed)):
                c = solve_batch(base, st)
                seq[label] = {"cold": c, "warm": solve_batch(moved, st, warm=c)}
                for k, r in seq[label].items():
                    if r.info.status.tolist() != [1]:
                        raise AssertionError(f"config 4 sequential {label} {k}: "
                                             f"{r.info.status.tolist()}")
            _reset_counts()
            multistage.cholesky_inverse_apply = recorded
            k2_by_chunks, calls0 = {}, dict(sharded_calls)
            for chunks in (4, 8):
                T_pad = max(2 * chunks, -(-MS_T // chunks) * chunks)
                before = dict(chol_inv.apply_launches_by_route)
                for label, st in (("float64", f64), ("mixed", mixed)):
                    cold, cold_s = _timed(torch, lambda: solve_horizon_sharded(
                        base, chunks=chunks, settings=st))
                    warm, warm_s = _timed(torch, lambda: solve_horizon_sharded(
                        moved, chunks=chunks, settings=st, warm=cold))
                    cpu_cold = solve_horizon_sharded(to_device(base, "cpu"), group=gloo,
                                                     chunks=chunks, settings=st)
                    cpu_warm = solve_horizon_sharded(to_device(moved, "cpu"), group=gloo,
                                                     chunks=chunks, settings=st, warm=cpu_cold)
                    for phase, res, cpu, secs in (("cold", cold, cpu_cold, cold_s),
                                                  ("warm", warm, cpu_warm, warm_s)):
                        what = f"config 4 chunks={chunks} {label} {phase}"
                        if res.info.status.tolist() != [1] or res.x.shape[-1] != T_pad * MS_D + MS_DA:
                            raise AssertionError(f"{what}: status {res.info.status.tolist()}, "
                                                 f"n {res.x.shape[-1]}")
                        host = _unpad_stage(res, MS_T, T_pad, MS_D, MS_DA, MS_RA, MS_RG)
                        ref = seq[label][phase].x[0].cpu().numpy()
                        dx_seq = float(np.abs(host["x"] - ref).max())
                        tol_seq = XCHECK_MIXED_TOL if st.mixed_precision else 1e-7 + 1e-6 * float(
                            np.abs(ref).max())
                        dx_cpu = (res.x.cpu() - cpu.x).abs().max().item()
                        same = (cpu.info.status.tolist() == [1]
                                and (st.mixed_precision
                                     or cpu.info.iter.tolist() == res.info.iter.cpu().tolist()))
                        tol_cpu = XCHECK_MIXED_TOL if st.mixed_precision else 1e-9
                        viol = _optimality(probs[phase], *(host[k] for k in (
                            "x", "y", "z_l", "z_u", "z_bl", "z_bu")))
                        print(f"[horizon] {what}: SOLVED in {int(res.info.iter)} iterations "
                              f"({secs * 1e3:.1f} ms, host clock), |x - x_sequential| "
                              f"{dx_seq:.2e} (limit {tol_seq:.1e}), CPU port "
                              f"{int(cpu.info.iter)} iterations |x_card - x_cpu| {dx_cpu:.2e} "
                              f"(limit {tol_cpu:.0e}), KKT {viol:.2e}; {smi}")
                        if not (dx_seq <= tol_seq and same and dx_cpu <= tol_cpu
                                and viol <= OPT_TOL and np.isfinite(host["x"]).all()):
                            raise AssertionError(f"{what} disagrees with its references")
                k2_by_chunks[chunks] = {k: chol_inv.apply_launches_by_route[k] - before[k]
                                        for k in before}
            calls = {k: sharded_calls[k] - calls0[k] for k in calls0}
            print(f"[horizon] config 4: sharded factors and solves (card and CPU) {calls}, "
                  f"K2 launches by route at 4 chunks {k2_by_chunks[4]}, at 8 chunks "
                  f"{k2_by_chunks[8]}")
            if not (k2_by_chunks[4]["small"] > 0
                    and k2_by_chunks[4]["resident"] == k2_by_chunks[4]["split"] == 0
                    and calls["factor"] > 0 and calls["solve"] > 0):
                raise AssertionError("config 4 at 4 chunks: the sharded factor did not launch "
                                     "the small K2 kernel")

            # the phase-7 fleet at 4 chunks, mixed cold and one warm round
            data7, data7w, s_ms = fleet["data"], fleet["data_w"], fleet["settings"]
            solve_horizon_sharded(data7, chunks=4, settings=s_ms)  # warm-up at this shape
            before = (dict(chol_inv.apply_launches_by_route), dict(sharded_calls))
            f_cold, f_cold_s = _timed(torch, lambda: solve_horizon_sharded(
                data7, chunks=4, settings=s_ms))
            f_warm, f_warm_s = _timed(torch, lambda: solve_horizon_sharded(
                data7w, chunks=4, settings=s_ms, warm=f_cold))
            k2_fleet = {k: chol_inv.apply_launches_by_route[k] - before[0][k] for k in before[0]}
            grew = all(sharded_calls[k] > before[1][k] for k in before[1])
            for phase, res, ref, secs, ref_s, shift in (
                    ("cold", f_cold, fleet["cold"], f_cold_s, fleet["cold_s"], None),
                    ("warm", f_warm, fleet["warm"], f_warm_s, fleet["warm_s"], fleet["dc"])):
                viol = _check_round(fleet["problems"](shift), res, f"sharded fleet {phase}")
                dx = (res.x - ref.x).abs().max().item()
                it, it7 = res.info.iter.cpu().numpy(), ref.info.iter.cpu().numpy()
                print(f"[horizon fleet {phase}] {data7.B}/{data7.B} SOLVED at 4 chunks, "
                      f"{secs * 1e3:.1f} ms a round against phase 7's {ref_s * 1e3:.1f} ms "
                      f"(host clock), iterations median {np.median(it):.1f} max {it.max()} "
                      f"(phase 7: {np.median(it7):.1f}, {it7.max()}), |x - x_phase7| {dx:.2e} "
                      f"(limit {XCHECK_MIXED_PAIR_TOL:.0e}), worst KKT {viol:.2e}; {smi}")
                if not dx <= XCHECK_MIXED_PAIR_TOL:
                    raise AssertionError(f"sharded fleet {phase} disagrees with phase 7")
            # the cold round's slowest problem alone: sharded on the card, and
            # sharded and sequential through the port on the CPU
            i = int(f_cold.info.iter.argmax())
            one = index(data7, slice(i, i + 1))
            alone = solve_horizon_sharded(one, chunks=4, settings=s_ms)
            cpu_alone = solve_horizon_sharded(to_device(one, "cpu"), group=gloo, chunks=4,
                                              settings=s_ms)
            cpu_seq = solve_batch(to_device(one, "cpu"), s_ms)
            dx = (alone.x.cpu() - cpu_alone.x).abs().max().item()
            print(f"[horizon fleet] slowest cold problem {i}: {int(f_cold.info.iter[i])} "
                  f"iterations in the fleet (phase 7: {int(fleet['cold'].info.iter[i])}); alone "
                  f"sharded {int(alone.info.iter[0])} on the card, {int(cpu_alone.info.iter[0])} "
                  f"on the CPU (sequential on the CPU {int(cpu_seq.info.iter[0])}), "
                  f"|x_card - x_cpu| {dx:.2e} (limit {XCHECK_MIXED_TOL:.0e})")
            if not (alone.info.status.tolist() == cpu_alone.info.status.tolist() == [1]
                    and dx <= XCHECK_MIXED_TOL):
                raise AssertionError(f"the sharded fleet's problem {i} disagrees with the CPU port")
            k2_by_dtype = dict(chol_inv.apply_launches_by_dtype)
            print(f"[horizon fleet] K2 launches by route {k2_fleet}; phase 14's K2 launches by "
                  f"dtype {k2_by_dtype}")
            if not (grew and k2_fleet["small"] > 0
                    and k2_fleet["resident"] == k2_fleet["split"] == 0):
                raise AssertionError(f"sharded fleet: K2 launches {k2_fleet}, sharded calls "
                                     f"grew {grew}")
            multistage.cholesky_inverse_apply = kernel
            checked = {(name, *shape) for name in ("float32", "float64") for shape in K2_SHAPES}
            print(f"[horizon] K2 shapes launched on the card (dtype, N, n, R): "
                  f"{sorted(launched)}, all held against the plain version in phase 2 "
                  f"{launched <= checked}")
            if not launched or not launched <= checked:
                raise AssertionError(f"K2 shapes of the sharded path never checked: "
                                     f"{sorted(launched - checked)}")

            # the batch over the group's ranks: phase 3's cold round again
            before = dict(chol_inv.launches_by_route)
            rb, rb_s = _timed(torch, lambda: solve_batch(
                dense["data"], dense["settings"], sharding=dist.group.WORLD))
            k1 = {k: chol_inv.launches_by_route[k] - before[k] for k in before}
            same = torch.equal(rb.x, dense["cold"].x) and torch.equal(
                rb.info.iter, dense["cold"].info.iter)
            print(f"[horizon batch] solve_batch(sharding=group) B={dense['data'].B}: "
                  f"{rb_s * 1e3:.1f} ms (host clock; phase 3 cold {dense['cold_s'] * 1e3:.1f} "
                  f"ms), x and iterations identical to phase 3 {same}, K1 launches by route "
                  f"{k1}; {smi}")
            if not (same and k1["resident"] > 0):
                raise AssertionError("solve_batch(sharding=...) differs from phase 3's cold round")

            # the reference of the multi-rank part: its runs on this one rank
            ref = _hz_runs(torch, dist.group.WORLD)
            _hz_check_reference(ref, smi)
        finally:
            multistage.cholesky_inverse_apply = kernel
            dist.destroy_process_group()
    k2_ranks = _hz_ranks_phase(torch, smi, ref)
    return dict(k2=k2_by_dtype, k1=k1, k2_ranks=k2_ranks)


# phase 15: the C interface's runs on the dense problem (name -> settings
# fields of piqp_tpu_settings, and the count of repeated cold solves timed
# after the first).  "startup" is the first call of the C driver's process
# (interpreter, torch import, CUDA context); "library" takes the library
# factorizations (pallas_kernels = 0) for contrast
CAPI_REPEAT = 3
CAPI_DENSE_RUNS = {
    "startup": {},
    "chol": {"repeat": CAPI_REPEAT},
    "mixed": {"mixed_precision": 1, "repeat": CAPI_REPEAT},
    "ldlt": {"kkt_solver": 7, "repeat": CAPI_REPEAT},
    "library": {"pallas_kernels": 0},
}
CAPI_SPARSE_RUNS = {"multistage": {"kkt_solver": 5, "repeat": CAPI_REPEAT}}
CAPI_F64_TOL = 1e-9


def _load_example(name: str):
    """Import examples/<name>.py of this checkout."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _count_dtoh(torch, fn) -> int:
    """Copies from a CUDA tensor to the host among the aten operations of
    ``fn`` (a ``TorchDispatchMode`` sees every one of them)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        copies = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves((args, kwargs))):
                outs = tree_leaves(out)
                if not any(isinstance(t, torch.Tensor) and t.is_cuda for t in outs):
                    Count.copies += 1  # a host tensor or a Python scalar from the card
            return out

    with Count():
        fn()
    return Count.copies


def _capi_phase(torch, smi, dense_prob: dict, dense_c: np.ndarray, stage_prob: dict,
                stage_c: np.ndarray, dev: str = "cuda") -> dict:
    """Phase 15: the port's C interface and examples on the card.  Builds
    the C library and driver (piqp_tpu_torch/capi/build_capi.sh), runs the
    driver's file-driven mode on CUDA in a subprocess (the dense problem
    through K1 in float64 and mixed precision, through K3, and with the
    library factorizations; the multistage problem through K2; each cold,
    repeated, then warm after an update of c), and the same runs through
    the Python entry points in a second fresh process (the control of the
    timings).  Holds every C result against the host KKT check and the
    same solve through the Python entry point in this process, whose kernel
    launches are counted by route, and runs the three examples.  Returns
    the in-process launches by kernel.  With ``dev="cpu"`` it rehearses
    the phase on the CPU (no launches to count)."""
    import dataclasses
    import os
    import shutil

    import scipy.sparse as sp

    from piqp_tpu_torch import DenseSolver, Info, Result, SparseSolver
    from piqp_tpu_torch.capi import pack_result, read_run, settings_from_fields, write_problem
    from piqp_tpu_torch.ops import chol_inv, signed_chol_inv

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "piqp_tpu_torch", "capi")
    t = time.perf_counter()
    build = subprocess.run(["sh", os.path.join(root, "piqp_tpu_torch", "capi", "build_capi.sh")],
                           capture_output=True, text=True, timeout=300)
    build_s = time.perf_counter() - t
    if build.returncode != 0:
        raise AssertionError(f"build_capi.sh failed:\n{build.stdout}\n{build.stderr}")
    print(f"[capi] build_capi.sh (g++ and gcc, no nvcc) {build_s:.2f} s: "
          f"{build.stdout.strip()}")

    work = os.path.join(out_dir, "phase15")
    shutil.rmtree(work, ignore_errors=True)
    dirs = {"dense": os.path.join(work, "dense"), "sparse": os.path.join(work, "sparse")}
    dims = {"dense": write_problem(dirs["dense"], dense_prob, c_update=dense_c,
                                   runs=CAPI_DENSE_RUNS),
            "sparse": write_problem(dirs["sparse"], stage_prob, sparse=True, c_update=stage_c,
                                    runs=CAPI_SPARSE_RUNS)}
    env = dict(os.environ)
    site = [p for p in sys.path if p.endswith("site-packages")]
    env["PYTHONPATH"] = os.pathsep.join([root] + site)
    control = ("import sys; from piqp_tpu_torch.capi import run_files; "
               "sys.exit(run_files(sys.argv[1], sys.argv[2:]))")
    process_s = {}
    for label, cmd in (("C", [os.path.join(out_dir, "test_capi")]),
                       ("Python", [sys.executable, "-c", control])):
        t = time.perf_counter()
        run = subprocess.run(cmd + [dev, dirs["dense"], dirs["sparse"]], capture_output=True,
                             text=True, env=env, timeout=600)
        process_s[label] = time.perf_counter() - t
        for line in run.stdout.strip().splitlines():
            print(f"[capi {label} process] {line}")
        if run.returncode != 0:
            raise AssertionError(f"the {label} process exited {run.returncode}:\n"
                                 f"{run.stderr[-4000:]}")
    print(f"[capi] the C driver's process {process_s['C']:.2f} s, the Python control's "
          f"{process_s['Python']:.2f} s ({len(CAPI_DENSE_RUNS) + len(CAPI_SPARSE_RUNS)} runs "
          f"each, host clock, start-up included)")
    tables = {"dense": CAPI_DENSE_RUNS, "sparse": CAPI_SPARSE_RUNS}
    c_runs = {name: read_run(dirs[kind], name, *dims[kind])
              for kind, table in tables.items() for name in table}
    py_runs = {name: read_run(dirs[kind], f"py-{name}", *dims[kind])
               for kind, table in tables.items() for name in table}

    # the same solves through the Python entry point in this process, with
    # the kernels' launches counted
    keys = ("x", "y", "z_l", "z_u", "z_bl", "z_bu")
    csc = {k: sp.csc_matrix(stage_prob[k]) for k in ("P", "A", "G")}
    problems = {"dense": (DenseSolver, dense_prob, dense_c),
                "sparse": (SparseSolver, dict(stage_prob, **csc), stage_c)}
    launches, py = {}, {}
    for kind, table in tables.items():
        cls, prob, c2 = problems[kind]
        for name, fields in table.items():
            if name == "startup":
                continue
            settings = settings_from_fields({k: v for k, v in fields.items() if k != "repeat"})
            _reset_counts()
            solver = cls(settings, device=dev)
            solver.setup(**prob)
            status = int(solver.solve())
            if kind == "sparse" and solver._stage_data is None:
                raise AssertionError("the multistage problem did not take the multistage route")
            cold = {k: getattr(solver.result, k).double().cpu().numpy() for k in keys}
            cold_iter = int(solver.result.info.iter)
            solver.update(c=c2)
            wstatus = int(solver.solve(warm_start=True))
            warm = {k: getattr(solver.result, k).double().cpu().numpy() for k in keys}
            py[name] = dict(status=status, iter=cold_iter, cold=cold, warm_status=wstatus,
                            warm_iter=int(solver.result.info.iter), warm=warm, solver=solver)
            launches[name] = {
                "K1": dict(chol_inv.launches_by_route),
                "K2": dict(chol_inv.apply_launches_by_route),
                "K3": dict(signed_chol_inv.launches_by_route),
                "K1_dtype": dict(chol_inv.launches_by_dtype),
                "K2_dtype": dict(chol_inv.apply_launches_by_dtype),
                "K3_dtype": dict(signed_chol_inv.launches_by_dtype),
            }
    expect = {"chol": ("K1", "resident"), "mixed": ("K1", "resident"),
              "ldlt": ("K3", "resident"), "multistage": ("K2", "small")}
    for name, (kernel, route) in expect.items():
        counts = launches[name][kernel]
        print(f"[capi] Python entry '{name}' in this process, cold + warm: {kernel} launches "
              f"by route {counts}; all K1 {launches[name]['K1']}, K2 {launches[name]['K2']}, "
              f"K3 {launches[name]['K3']}")
        if dev == "cuda" and not (counts[route] > 0 and sum(counts.values()) == counts[route]):
            raise AssertionError(f"the Python entry's '{name}' solve did not launch {kernel} "
                                 f"on its {route} route: {counts}")
    if any(sum(launches["library"][k].values()) for k in ("K1", "K2", "K3")):
        raise AssertionError(f"pallas_kernels=False launched a kernel: {launches['library']}")

    # every C result: SOLVED, optimal on the host, equal to the Python entry
    probs = {"dense": (dense_prob, dict(dense_prob, c=dense_c)),
             "sparse": (stage_prob, dict(stage_prob, c=stage_c))}
    for name, c_run in c_runs.items():
        ref = py["chol" if name == "startup" else name]
        kind = "sparse" if name in CAPI_SPARSE_RUNS else "dense"
        mixed = name == "mixed"
        for phase, key, prob in (("cold", "", probs[kind][0]), ("warm", "warm_", probs[kind][1])):
            status, it = c_run[f"{key}status"], c_run[f"{key}iter"]
            viol = _optimality(prob, *(c_run[phase][k] for k in keys))
            dx = float(np.abs(c_run[phase]["x"] - ref[phase]["x"]).max())
            same = bool(np.array_equal(c_run[phase]["x"], ref[phase]["x"]))
            same_py = bool(np.array_equal(c_run[phase]["x"], py_runs[name][phase]["x"]))
            tol = XCHECK_MIXED_TOL if mixed else CAPI_F64_TOL
            print(f"[capi {name} {phase}] status {status}, {it} iterations (Python entry "
                  f"{ref[f'{key}status']}, {ref[f'{key}iter']}), host KKT {viol:.2e}, "
                  f"|x_C - x_py| {dx:.3e} (limit {tol:.0e}), bitwise equal {same}; to the "
                  f"Python control process {same_py}")
            if not (status == 1 and viol <= OPT_TOL and dx <= tol
                    and ref[f"{key}status"] == status
                    and (mixed or it == ref[f"{key}iter"])):
                raise AssertionError(f"C interface '{name}' {phase} disagrees with the Python "
                                     f"entry or is not optimal")
    lib_dx = float(np.abs(c_runs["library"]["cold"]["x"] - py["chol"]["cold"]["x"]).max())
    print(f"[capi] C defaults (pallas_kernels -1) vs the Python default: iterations "
          f"{c_runs['chol']['iter']} / {py['chol']['iter']}, x bitwise equal "
          f"{bool(np.array_equal(c_runs['chol']['cold']['x'], py['chol']['cold']['x']))}; "
          f"the library route (pallas_kernels 0) lies {lib_dx:.3e} from the kernels' x")

    # the C layer's cost a call: the C process against the Python control
    # process, each fresh and running the same calls in the same order (the
    # first solve of a run is its process's first of that kind; the
    # repeated solve is the median of CAPI_REPEAT more)
    for name in ("chol", "mixed", "ldlt", "multistage"):
        c_s, p_s = c_runs[name]["seconds"], py_runs[name]["seconds"]
        print(f"[capi time {name}] C / Python ms: " + ", ".join(
            f"{k} {c_s[k] * 1e3:.3f} / {p_s[k] * 1e3:.3f} ({(c_s[k] - p_s[k]) * 1e3:+.3f})"
            for k in ("setup", "solve", "repeat_solve", "update", "warm_solve")) + f"; {smi}")
    with open("/proc/self/maps") as maps:
        shared = "libpython" in maps.read()
    print(f"[capi] the Python processes' interpreter {sys.executable} is "
          f"{'the shared libpython' if shared else 'statically linked'}; the C driver embeds "
          f"the shared libpython that python3-config names")
    c_st, p_st = c_runs["startup"]["seconds"], py_runs["startup"]["seconds"]
    print(f"[capi time startup] the C process's first setup {c_st['setup']:.3f} s (interpreter, "
          f"torch import, CUDA context) and solve {c_st['solve']:.3f} s; the Python control's "
          f"{p_st['setup']:.3f} s (CUDA context; its imports came before) and "
          f"{p_st['solve']:.3f} s; {smi}")

    # the C layer reads a result back in one device-to-host copy
    vectors = tuple(f.name for f in dataclasses.fields(Result) if f.name != "info")
    info = tuple(f.name for f in dataclasses.fields(Info))
    result = py["chol"]["solver"].result
    copies = _count_dtoh(torch, lambda: pack_result(result, vectors, info))
    pack_s = statistics.median(_timed(torch, lambda: pack_result(result, vectors, info), dev)[1]
                               for _ in range(20))
    print(f"[capi] pack_result of an n = {MAIN_N} result: {copies} copies to the host, "
          f"{pack_s * 1e3:.3f} ms (median of 20, host clock); {smi}")
    if dev == "cuda" and copies != 1:
        raise AssertionError(f"pack_result made {copies} copies to the host, not 1")

    # the examples on the card
    for name in ("torch_batch_example", "torch_mpc_example", "torch_diff_mpc_example"):
        example = _load_example(name)
        _reset_counts()
        t = time.perf_counter()
        out = example.main(device=dev)
        secs = time.perf_counter() - t
        if name == "torch_diff_mpc_example" and not out["losses"][-1] < out["losses"][0]:
            raise AssertionError("the learned weights did not move the loss down")
        summary = {"torch_batch_example": lambda o: f"{int((o['status'] == 1).sum())} + "
                                                    f"{int((o['warm_status'] == 1).sum())} SOLVED",
                   "torch_mpc_example": lambda o: f"tracking errors {np.round(o['tracking'], 4)}",
                   "torch_diff_mpc_example": lambda o: f"loss {o['losses'][0]:.3e} -> "
                                                       f"{o['final_loss']:.3e}"}[name](out)
        print(f"[example {name}] {secs:.2f} s, {summary}; K1 launches by route "
              f"{dict(chol_inv.launches_by_route)}, K2 {dict(chol_inv.apply_launches_by_route)}")
        launches[name] = {"K1": dict(chol_inv.launches_by_route),
                          "K2": dict(chol_inv.apply_launches_by_route)}
    return launches


def _xcheck(label, cpu, gpu, mixed: bool, tol=None, same_iter=False) -> None:
    """CPU (plain versions) against the card on the same problems: equal
    status (and, with ``same_iter``, equal iterations) and x within ``tol``
    (XCHECK_MIXED_TOL for mixed precision, else 1e-6 unless given)."""
    same_status = cpu.info.status.tolist() == gpu.info.status.cpu().tolist()
    same_it = cpu.info.iter.tolist() == gpu.info.iter.cpu().tolist()
    dx = (cpu.x - gpu.x.cpu()).abs().max().item()
    if tol is None:
        tol = XCHECK_MIXED_TOL if mixed else 1e-6
    print(f"[cross-check {label}] on the CPU: status equal {same_status}, max "
          f"|x_cpu - x_gpu| {dx:.3e} (limit {tol:.0e}), iterations cpu "
          f"{cpu.info.iter.tolist()} gpu {gpu.info.iter.cpu().tolist()}")
    if not (same_status and dx <= tol and (same_it or not same_iter)):
        raise AssertionError(f"the {label} CPU cross-check disagrees with the card")


def _dense256_phase(torch, smi) -> dict:
    """Phase 16: the n = 256 dense fleet, mixed cold and one warm round (and
    a profile of the warm round) and a float64 cold round of 64, every K1
    launch on the cluster route; problems 0-1 again on the CPU; a float64
    DenseSolver at n = 200.
    Returns the fleet's mixed rounds' K1 launches by dtype, route and
    cluster size."""
    from piqp_tpu_torch import (
        DenseSolver, Settings, Status, prepare_batch, solve_batch, warm_from_result,
    )
    from piqp_tpu_torch.ops import chol_inv
    from piqp_tpu_torch.types import index
    from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

    B, n = N256_B, N256_N
    t0 = time.perf_counter()
    problems = [dense_strongly_convex_qp(n, n // 2, n // 2, seed=1000 + i) for i in range(B)]
    rng = np.random.default_rng(2026)
    moved = [dict(p, c=p["c"] + 1e-3 * rng.standard_normal(n)) for p in problems]
    data, data_w = prepare_batch(problems, device="cuda"), prepare_batch(moved, device="cuda")
    _sync(torch, "cuda")
    print(f"[n256] prepared {B} problems n={n} p={n // 2} m={n // 2} in "
          f"{time.perf_counter() - t0:.2f} s")
    mixed, f64 = Settings(mixed_precision=True), Settings()
    solve_batch(prepare_batch(problems[:2], device="cuda"), mixed)  # warm-up

    def k1_counts():
        return (dict(chol_inv.launches_by_dtype), dict(chol_inv.launches_by_route),
                dict(chol_inv.launches_by_cluster))

    def check_cluster(label, counts, want_clusters):
        """Every K1 launch of a run on the cluster route with the cluster
        sizes ``want_clusters`` (dtype -> size) names, > 0 in each dtype."""
        by_dtype, by_route, by_cluster = counts
        want = {c: sum(by_dtype[d] for d, k in want_clusters.items() if k == c)
                for c in by_cluster}
        print(f"[n256] {label}: K1 launches by dtype {by_dtype}, by route {by_route}, "
              f"by cluster size {by_cluster}")
        if not (all(by_dtype[d] > 0 for d in want_clusters)
                and by_route == {"resident": 0, "cluster": sum(by_dtype.values())}
                and by_cluster == want):
            raise AssertionError(f"{label}: K1 launches must all take the cluster route "
                                 f"with clusters {want_clusters}, > 0 per dtype")

    clusters = {str(dt).removeprefix("torch."): chol_inv.cluster_size(n, dt)
                for dt in (torch.float32, torch.float64)}
    _reset_counts()
    cold, cold_s = _timed(torch, lambda: solve_batch(data, mixed))
    warm_pt = warm_from_result(cold)
    warm, warm_s = _timed(torch, lambda: solve_batch(data_w, mixed, warm=warm_pt))
    launches = k1_counts()
    check_cluster("mixed cold + warm", launches, clusters)
    for label, res, secs, probs in (("cold", cold, cold_s, problems),
                                    ("warm", warm, warm_s, moved)):
        viol = _check_round(probs, res, f"n = 256 mixed {label}")
        it = res.info.iter.cpu().numpy()
        print(f"[n256 {label}] {B}/{B} SOLVED, {B / secs:.1f} solves/s ({secs * 1e3:.1f} ms, "
              f"host clock), iterations median {np.median(it):.1f} max {it.max()}, worst KKT "
              f"violation {viol:.2e}; {smi}")

    _profile_round(torch, "n256 warm", lambda: solve_batch(data_w, mixed, warm=warm_pt),
                   warm_s, smi, ("chol_inv_cluster_kernel",))

    _reset_counts()
    sub = problems[:N256_B64]
    res64, secs = _timed(torch, lambda: solve_batch(prepare_batch(sub, device="cuda"), f64))
    check_cluster("float64 cold", k1_counts(), {"float64": clusters["float64"]})
    viol = _check_round(sub, res64, "n = 256 float64")
    print(f"[n256 f64] B={N256_B64} {N256_B64}/{N256_B64} SOLVED, {N256_B64 / secs:.1f} "
          f"solves/s ({secs * 1e3:.1f} ms, host clock), iterations max "
          f"{int(res64.info.iter.max())}, worst KKT {viol:.2e}; {smi}")

    # problems 0-1 again on the CPU (plain versions): float64 follows the
    # same trajectory (equal iterations); mixed precision rounds its
    # float32 phase differently on each device
    _xcheck("n256 float64, problems 0-1",
            solve_batch(prepare_batch(problems[:2], device="cpu"), f64),
            index(res64, slice(0, 2)), mixed=False, tol=XCHECK_F64_TOL, same_iter=True)
    _xcheck("n256 mixed, problems 0-1",
            solve_batch(prepare_batch(problems[:2], device="cpu"), mixed),
            index(cold, slice(0, 2)), mixed=True)

    # a float64 DenseSolver at n = 200: the cluster route in float64 only
    prob = dense_strongly_convex_qp(N200, N200 // 2, N200 // 2, seed=200)
    c_moved = prob["c"] + 1e-3 * rng.standard_normal(N200)
    _reset_counts()
    solver = DenseSolver(f64, device="cuda")
    solver.setup(**prob)
    status_cold = solver.solve()
    it_cold = int(solver.result.info.iter)
    viol_cold = _optimality(prob, *(getattr(solver.result, k).cpu().numpy()
                                    for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu")))
    solver.update(c=c_moved)
    status_warm = solver.solve(warm_start=True)
    r = solver.result
    viol_warm = _optimality(dict(prob, c=c_moved), *(getattr(r, k).cpu().numpy()
                                                    for k in ("x", "y", "z_l", "z_u", "z_bl",
                                                              "z_bu")))
    print(f"[n200 f64] DenseSolver(device='cuda') n={N200} p=m={N200 // 2}: cold "
          f"{status_cold.name} in {it_cold} iterations, KKT {viol_cold:.2e}; update(c) + warm "
          f"{status_warm.name} in {int(r.info.iter)} iterations, KKT {viol_warm:.2e}")
    check_cluster("n = 200 float64 DenseSolver", k1_counts(),
                  {"float64": chol_inv.cluster_size(N200, torch.float64)})
    if not (status_cold == status_warm == Status.SOLVED and max(viol_cold, viol_warm) <= OPT_TOL):
        raise AssertionError("the n = 200 float64 DenseSolver did not solve to the KKT limit")
    return dict(zip(("by_dtype", "by_route", "by_cluster"), launches))


def _wide_stage_phase(torch, smi, tag: str, B: int, D: int, B64: int, seed0: int,
                      noise_seed: int, route: str, levels: list, kernels: tuple) -> dict:
    """Phases 17 and 18: a multistage fleet of B problems at T = 41 with
    stages D wide (seeds seed0 + i), mixed cold and one warm round after
    c += 1e-3 N(0, 1) (and a profile of the warm round, with the shares of
    ``kernels``) and a float64 cold round of the first B64, every K2 launch
    on ``route`` (on the split route with its factor on the route
    ``kernel_route`` names); host KKT checks of every problem on sparse
    matrices assembled from its stage blocks; problems 0-1 again on the CPU.
    ``levels`` are the K2 shapes the fleet launches, whose bounds it prints.
    Returns the fleet's K2 launches (mixed rounds and float64 round) by
    dtype, by route and, on the split route, by factor route."""
    import dataclasses

    from piqp_tpu_torch import Settings, solve_batch, warm_from_result
    from piqp_tpu_torch import multistage as ms
    from piqp_tpu_torch.ops import chol_inv
    from piqp_tpu_torch.types import index, to_device

    T = MS48_T
    dims = dict(T=T, D=D, Da=MS48_DA, ra=4, rg=4)
    if not ms._use_cr(T):
        raise AssertionError(f"T = {T} does not select cyclic reduction")
    seeds = [seed0 + i for i in range(B)]
    t0 = time.perf_counter()
    data = ms.random_multistage_batch(seeds, **dims, device="cuda")
    rng = np.random.default_rng(noise_seed)
    dc = rng.standard_normal((B, data.n)) * 1e-3
    data_w = dataclasses.replace(data, c=data.c + torch.as_tensor(dc, device="cuda"))
    _sync(torch, "cuda")
    base = [_stage_problem_sparse(ms.random_multistage_arrays(seed=s, **dims)) for s in seeds]

    def problems(count=B, shift=None):
        """The first ``count`` problems, c moved by ``shift``."""
        return [p if shift is None else dict(p, c=p["c"] + shift[i])
                for i, p in enumerate(base[:count])]

    print(f"[{tag}] prepared {B} problems T={T} D={D} Da={MS48_DA} (n={data.n} p={data.p} "
          f"m={data.m}) in {time.perf_counter() - t0:.2f} s")
    R = 2 * D + MS48_DA
    for dt in (torch.float32, torch.float64):
        if chol_inv.apply_kernel_route(D, dt, R) != route:
            raise AssertionError(f"D = {D}, R = {R} is not routed to K2's {route} route")
    for N, _, _ in levels:
        bounds = [_bound(name, (_factor_elements(N, D) + 2 * N * D * R) * size,
                         N * (2 * D ** 3 / 3 + 2 * D * D * R))
                  for name, size in (("float32", 4), ("float64", 8))]
        print(f"[{tag}] K2 level shape N={N} D={D} R={R}: bound float32 "
              f"{bounds[0][0] * 1e3:.2f} us ({bounds[0][1]}), float64 {bounds[1][0] * 1e3:.2f} us "
              f"({bounds[1][1]})")
    mixed, f64 = Settings(mixed_precision=True), Settings()
    solve_batch(index(data, slice(0, 2)), mixed)  # warm-up

    def k2_counts():
        return (dict(chol_inv.apply_launches_by_dtype), dict(chol_inv.apply_launches_by_route),
                dict(chol_inv.apply_factor_launches_by_route))

    def check_route(label, counts, dtypes):
        """Every K2 launch of a run on ``route`` (a split call's factor on
        the route kernel_route names), > 0 per dtype."""
        by_dtype, by_route, by_factor = counts
        print(f"[{tag}] {label}: K2 launches by dtype {by_dtype}, by route {by_route}"
              + (f", split factors by route {by_factor}" if route == "split" else ""))
        factors = {k: 0 for k in by_factor}
        if route == "split":
            for d in dtypes:
                factors[chol_inv.kernel_route(D, getattr(torch, d))] += by_dtype[d]
        if not (all(by_dtype[d] > 0 for d in dtypes)
                and by_route == {k: sum(by_dtype.values()) if k == route else 0 for k in by_route}
                and by_factor == factors):
            raise AssertionError(f"{label}: K2 launches must all take the {route} route, "
                                 f"> 0 in {dtypes}")

    _reset_counts()
    cold, cold_s = _timed(torch, lambda: solve_batch(data, mixed))
    warm_pt = warm_from_result(cold)
    warm, warm_s = _timed(torch, lambda: solve_batch(data_w, mixed, warm=warm_pt))
    launches = k2_counts()
    check_route("mixed cold + warm", launches, ("float32", "float64"))
    for label, res, secs, shift in (("cold", cold, cold_s, None), ("warm", warm, warm_s, dc)):
        viol = _check_round(problems(shift=shift), res, f"D = {D} multistage mixed {label}")
        it = res.info.iter.cpu().numpy()
        print(f"[{tag} {label}] {B}/{B} SOLVED, {B / secs:.1f} solves/s ({secs * 1e3:.1f} ms, "
              f"host clock), iterations median {np.median(it):.1f} max {it.max()}, worst KKT "
              f"violation {viol:.2e}; {smi}")

    _profile_round(torch, f"{tag} warm", lambda: solve_batch(data_w, mixed, warm=warm_pt),
                   warm_s, smi, kernels)

    _reset_counts()
    res64, secs = _timed(torch, lambda: solve_batch(index(data, slice(0, B64)), f64))
    launches64 = k2_counts()
    check_route("float64 cold", launches64, ("float64",))
    viol = _check_round(problems(B64), res64, f"D = {D} multistage float64")
    print(f"[{tag} f64] B={B64} {B64}/{B64} SOLVED, {B64 / secs:.1f} "
          f"solves/s ({secs * 1e3:.1f} ms, host clock), iterations max "
          f"{int(res64.info.iter.max())}, worst KKT {viol:.2e}; {smi}")

    # problems 0-1 again on the CPU (plain versions): float64 follows the
    # same trajectory (equal iterations); mixed precision rounds its
    # float32 phase differently on each device
    cpu = to_device(index(data, slice(0, 2)), "cpu")
    _xcheck(f"{tag} float64, problems 0-1", solve_batch(cpu, f64), index(res64, slice(0, 2)),
            mixed=False, tol=XCHECK_F64_TOL, same_iter=True)
    _xcheck(f"{tag} mixed, problems 0-1", solve_batch(cpu, mixed), index(cold, slice(0, 2)),
            mixed=True)
    return {key: {k: a[k] + b[k] for k in a}
            for key, a, b in zip(("by_dtype", "by_route", "by_factor"), launches, launches64)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    import dataclasses

    import scipy.sparse as sp

    from piqp_tpu_torch import (
        DenseSolver, KKTBackend, Settings, SparseSolver, Status, prepare_batch,
        solve_batch, warm_from_result,
    )
    from piqp_tpu_torch import _native
    from piqp_tpu_torch import multistage
    from piqp_tpu_torch.ops import _build, chol_inv, signed_chol_inv
    from piqp_tpu_torch.types import index, to_device
    from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

    # ---- 1. device and build
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi}")
    print(f"[device] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 matmuls are enabled; the port needs full float32")
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] nvcc {_build.BuildInfo.seconds:.2f} s (load incl. "
          f"{time.perf_counter() - t0:.2f} s), library {_build.LIB_PATH.name}")
    print(_build.BuildInfo.log.strip())

    # ---- 2. K1 against its plain version on the card, on both kernel routes
    def k1_check(name, K, L, Linv, what) -> float:
        """L and Linv against the plain version; returns the worst error."""
        tol = K1_TOL[name]
        n = K.shape[-1]
        torch.cuda.synchronize()
        L_ref, Linv_ref = chol_inv.chol_inv_reference(K)
        err_L = (L - L_ref).abs().max().item()
        eye = torch.eye(n, dtype=K.dtype, device="cuda")
        err_I = (L @ Linv - eye).abs().max().item()
        err_Li = (Linv - Linv_ref).abs().max().item()
        if what:
            print(f"[K1 {name}] {what} B={K.shape[0]} n={n}: |L-L_ref| {err_L:.3e} "
                  f"|Linv-Linv_ref| {err_Li:.3e} |L Linv - I| {err_I:.3e}")
        if not (err_L <= tol * max(1.0, L_ref.abs().max().item())
                and err_Li <= tol * Linv_ref.abs().max().item()
                and err_I <= 50 * tol):
            raise AssertionError(f"K1 {name} {what} B={K.shape[0]} n={n} disagrees with "
                                 f"its plain version")
        if bool(torch.triu(L, 1).any()) or bool(torch.triu(Linv, 1).any()):
            raise AssertionError(f"K1 {name} {what} n={n}: nonzero upper triangle")
        return max(err_L, err_Li)

    def k1_routed(K):
        """cholesky_with_inverse, checked to launch the route kernel_route
        names, on the cluster route with the cluster size cluster_size names;
        returns the route's label, L and Linv."""
        n = K.shape[-1]
        route = chol_inv.kernel_route(n, K.dtype)
        cluster = chol_inv.cluster_size(n, K.dtype) if route == "cluster" else None
        before = (dict(chol_inv.launches_by_route), dict(chol_inv.launches_by_cluster))
        L, Linv = chol_inv.cholesky_with_inverse(K)
        grown = ({k: chol_inv.launches_by_route[k] - before[0][k] for k in before[0]},
                 {k: chol_inv.launches_by_cluster[k] - before[1][k] for k in before[1]})
        if grown != ({k: int(k == route) for k in before[0]},
                     {k: int(k == cluster) for k in before[1]}):
            raise AssertionError(f"K1 n={n} {K.dtype}: route {route} cluster {cluster}, "
                                 f"launches {grown}")
        return (route if cluster is None else f"cluster c={cluster}"), L, Linv

    kernels = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        worst = {"resident": 0.0, "cluster": 0.0}
        for B, n in K1_SHAPES:
            K = _spd_batch(torch, B, n, dtype, seed=n)
            route, L, Linv = k1_routed(K)
            err = k1_check(name, K, L, Linv, route)
            worst[route.split()[0]] = max(worst[route.split()[0]], err)
        # every n of the cluster route
        cluster_ns = range(chol_inv.RESIDENT_MAX_N[name] + 1, chol_inv.MAX_KERNEL_N + 1)
        sweep = {}
        for n in cluster_ns:
            K = _spd_batch(torch, 3, n, dtype, seed=n)
            route, L, Linv = k1_routed(K)
            sweep[route] = sweep.get(route, 0) + 1
            worst["cluster"] = max(worst["cluster"], k1_check(name, K, L, Linv, ""))
        print(f"[K1 {name}] every n of the cluster route, {cluster_ns.start}-{cluster_ns.stop - 1} "
              f"(B=3): shapes by route {sweep}, all within {K1_TOL[name]:.0e} of the plain "
              f"version; worst error on the cluster route {worst['cluster']:.3e}")
        # one indefinite problem gives non-finite output for itself only, on
        # the resident route and on each cluster size
        for n in (40, 200, 250):
            K = _spd_batch(torch, 4, n, dtype, seed=1)
            K[2, 7, 7] = -1e3
            route, L, Linv = k1_routed(K)
            fin = (torch.isfinite(L).flatten(1).all(1) & torch.isfinite(Linv).flatten(1).all(1))
            print(f"[K1 {name}] {route} n={n}: one indefinite problem of 4, finite flags "
                  f"{fin.tolist()}")
            if fin.tolist() != [True, True, False, True]:
                raise AssertionError(f"K1 {name} {route}: indefinite input gave finite "
                                     f"flags {fin.tolist()}")

        # each route at its fleet's shape: the kernel, the plain version and
        # the library; on the cluster route also K3's kernel with every
        # sign +1, held to K1's plain version first
        for B, n, label in ((MAIN_B, MAIN_N, "resident"), (N256_B, N256_N, "cluster")):
            K = _spd_batch(torch, B, n, dtype, seed=7)
            if chol_inv.kernel_route(n, dtype) != label:
                raise AssertionError(f"K1 {name} n={n} is not routed to the {label} kernel")
            ms = _time_ms(torch, lambda: chol_inv.cholesky_with_inverse(K))
            plain_ms = _time_ms(torch, lambda: chol_inv.chol_inv_reference(K), count=3,
                                windows=1)
            eye = torch.eye(n, dtype=dtype, device="cuda").expand_as(K)

            def library():
                Lc = torch.linalg.cholesky(K)
                return torch.linalg.solve_triangular(Lc, eye, upper=False)

            library_ms = _time_ms(torch, library)
            bound_ms, bound_by = _bound(name, _factor_elements(B, n) * K.element_size(),
                                        2 * B * n ** 3 / 3)
            entry = dict(
                name=f"chol_inv_{name}", route="cuda", kernel_route=label,
                source="piqp_tpu_torch/csrc/chol_inv_resident.cu",
                replaces="piqp_tpu/ops/pallas_chol.py:65",
                launches=None, max_abs_err=worst[label], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            )
            extra = ""
            if label == "cluster":
                ones = torch.ones(n, dtype=dtype, device="cuda")
                k3 = lambda: signed_chol_inv.signed_cholesky_with_inverse(K, ones)
                k1_check(name, K, *k3(),
                         f"K3 kernel, signs +1, c={signed_chol_inv.cluster_size(n, dtype)},")
                k3_ms = _time_ms(torch, k3)
                entry.update(name=f"chol_inv_cluster_{name}",
                             cluster=chol_inv.cluster_size(n, dtype),
                             source="piqp_tpu_torch/csrc/signed_chol_inv_resident.cu",
                             k3_plus_ms=k3_ms)
                extra = f", K3 kernel with signs +1 {k3_ms:.4f} ms (cluster/K3 {ms / k3_ms:.2f}x)"
            print(f"[K1 {name}] {label} B={B} n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library {library_ms:.4f} ms{extra}, bound {bound_ms * 1e3:.1f} us "
                  f"({bound_by}); library/kernel {library_ms / ms:.2f}x, kernel/bound "
                  f"{ms / bound_ms:.2f}x; {smi}")
            kernels.append(entry)

    # ---- 2b. K2 and K3 against their plain versions on the card
    kernels += _check_k2(torch, smi)
    kernels += _check_k3(torch, smi)

    # ---- 3. main path at full width: cold + one warm round, mixed precision
    problems = [
        dense_strongly_convex_qp(MAIN_N, MAIN_P, MAIN_M, seed=1000 + i)
        for i in range(MAIN_B)
    ]
    settings = Settings(mixed_precision=True)
    t0 = time.perf_counter()
    data = prepare_batch(problems)
    torch.cuda.synchronize()
    print(f"[main] prepared {MAIN_B} problems n={MAIN_N} p={MAIN_P} m={MAIN_M} "
          f"in {time.perf_counter() - t0:.2f} s")
    solve_batch(prepare_batch(problems[:2]), settings)  # warm-up: cuBLAS handles, allocator

    _reset_counts()
    round_launches = {}

    def run_round(label, data, warm=None):
        before = dict(chol_inv.launches_by_dtype)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = solve_batch(data, settings, warm=warm)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        grown = {k: chol_inv.launches_by_dtype[k] - before[k] for k in before}
        round_launches[label] = grown
        if not (grown["float32"] > 0 and grown["float64"] > 0):
            raise AssertionError(f"{label}: K1 launches per dtype {grown}; both phases must launch it")
        return res, secs

    cold, cold_s = run_round("cold", data)
    rng = np.random.default_rng(2024)
    moved = [dict(p, c=p["c"] + 1e-3 * rng.standard_normal(MAIN_N)) for p in problems]
    data_w = prepare_batch(moved)
    warm_pt = warm_from_result(cold)
    warm, warm_s = run_round("warm", data_w, warm_pt)
    main_launches = dict(chol_inv.launches_by_dtype)
    main_routes = dict(chol_inv.launches_by_route)
    print(f"[main] K1 launches in the cold + warm rounds: by dtype {main_launches}, "
          f"by route {main_routes}")
    if main_routes != {"resident": sum(main_launches.values()), "cluster": 0}:
        raise AssertionError(f"main path K1 launches by route {main_routes}: all must be resident")

    cold_viol = _check_round(problems, cold, "cold")
    warm_viol = _check_round(moved, warm, "warm")
    for label, res, secs, viol in (("cold", cold, cold_s, cold_viol),
                                   ("warm", warm, warm_s, warm_viol)):
        it = res.info.iter.cpu().numpy()
        print(f"[main {label}] {MAIN_B}/{MAIN_B} SOLVED, {MAIN_B / secs:.1f} solves/s "
              f"({secs:.3f} s), iterations median {np.median(it):.1f} max {it.max()}, "
              f"K1 launches {round_launches[label]}, worst KKT violation {viol:.2e}; {smi}")
    for entry in kernels:
        if entry["name"].startswith("chol_inv_float"):
            entry["launches"] = main_launches[entry["name"].removeprefix("chol_inv_")]

    # ---- 4. pure float64, one DenseSolver on the card, CPU cross-check
    f64 = Settings()
    sub = problems[:64]
    before = dict(chol_inv.launches_by_dtype)
    t = time.perf_counter()
    res64 = solve_batch(prepare_batch(sub), f64)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    viol = _check_round(sub, res64, "float64 B=64")
    grown = chol_inv.launches_by_dtype["float64"] - before["float64"]
    if grown <= 0:
        raise AssertionError("float64 batch did not launch K1 in float64")
    print(f"[f64] B=64 all SOLVED in {secs:.3f} s, iterations max "
          f"{int(res64.info.iter.max())}, K1 float64 launches {grown}, worst KKT {viol:.2e}")

    solver = DenseSolver(f64, device="cuda")
    solver.setup(**problems[0])
    if solver.solve() != Status.SOLVED:
        raise AssertionError("DenseSolver did not solve problem 0")
    it0 = int(solver.result.info.iter)
    solver.update(c=moved[0]["c"])
    if solver.solve(warm_start=True) != Status.SOLVED:
        raise AssertionError("DenseSolver did not solve the updated problem 0")
    r = solver.result
    viol = _optimality(moved[0], *(getattr(r, k).cpu().numpy()
                                   for k in ("x", "y", "z_l", "z_u", "z_bl", "z_bu")))
    if not viol <= OPT_TOL:
        raise AssertionError(f"DenseSolver KKT violation {viol:.3e}")
    print(f"[single] DenseSolver(device='cuda') n={MAIN_N}: setup/solve {it0} iterations, "
          f"update/warm solve {int(r.info.iter)} iterations, KKT {viol:.2e}")

    # The first 8 problems again on the CPU (plain versions).  In float64
    # both devices follow the same trajectory, so x agrees to 1e-6.  With
    # mixed precision the float32 phase rounds differently on each device
    # and the runs stop at different (equally optimal) iterates: there x
    # is held to XCHECK_MIXED_TOL.
    for label, st, gpu in (("float64", f64, index(res64, slice(0, 8))),
                           ("mixed", settings, index(cold, slice(0, 8)))):
        cpu = solve_batch(prepare_batch(problems[:8], device="cpu"), st)
        same_status = cpu.info.status.tolist() == gpu.info.status.cpu().tolist()
        dx = (cpu.x - gpu.x.cpu()).abs().max().item()
        tol = 1e-6 if label == "float64" else XCHECK_MIXED_TOL
        print(f"[cross-check {label}] first 8 problems on the CPU: status equal "
              f"{same_status}, max |x_cpu - x_gpu| {dx:.3e} (limit {tol:.0e}), "
              f"iterations cpu {cpu.info.iter.tolist()} gpu {gpu.info.iter.cpu().tolist()}")
        if not (same_status and dx <= tol):
            raise AssertionError(f"the {label} CPU cross-check disagrees with the card")

    # ---- 5. where the warm round's device time goes
    _profile_round(torch, "warm", lambda: solve_batch(data_w, settings, warm=warm_pt),
                   warm_s, smi, ("chol_inv_resident_kernel",))

    # ---- 6. dense_ldlt fleet: the full 3-block KKT through K3
    lprobs, lmoved = problems[:LDLT_B], moved[:LDLT_B]
    s_ldlt = Settings(kkt_solver=KKTBackend.dense_ldlt, mixed_precision=True)
    data6, data6w = prepare_batch(lprobs), prepare_batch(lmoved)
    solve_batch(prepare_batch(lprobs[:2]), s_ldlt)  # warm-up
    _reset_counts()
    cold6, cold6_s = _timed(torch, lambda: solve_batch(data6, s_ldlt))
    warm6_pt = warm_from_result(cold6)
    warm6, warm6_s = _timed(torch, lambda: solve_batch(data6w, s_ldlt, warm=warm6_pt))
    k3_launches = dict(signed_chol_inv.launches_by_dtype)
    if not (k3_launches["float32"] > 0 and k3_launches["float64"] > 0):
        raise AssertionError(f"dense_ldlt fleet: K3 launches per dtype {k3_launches}")
    k3_routes = dict(signed_chol_inv.launches_by_route)
    k3_clusters = {c: k for c, k in signed_chol_inv.launches_by_cluster.items() if k}
    if k3_routes != {"resident": sum(k3_launches.values())}:
        raise AssertionError(f"dense_ldlt fleet K3 launches by route {k3_routes}: all must "
                             f"be resident")
    for label, res, secs, probs in (("cold", cold6, cold6_s, lprobs),
                                    ("warm", warm6, warm6_s, lmoved)):
        viol = _check_round(probs, res, f"dense_ldlt {label}")
        it = res.info.iter.cpu().numpy()
        print(f"[ldlt {label}] {LDLT_B}/{LDLT_B} SOLVED (n+p+m = 256), "
              f"{LDLT_B / secs:.1f} solves/s ({secs:.3f} s), iterations median "
              f"{np.median(it):.1f} max {it.max()}, worst KKT violation {viol:.2e}; {smi}")
    print(f"[ldlt] K3 launches in the mixed cold + warm rounds: by dtype {k3_launches}, "
          f"by route {k3_routes}, by cluster size {k3_clusters}")
    f64_ldlt = Settings(kkt_solver=KKTBackend.dense_ldlt)
    before = signed_chol_inv.launches_by_dtype["float64"]
    res6_64, secs = _timed(torch, lambda: solve_batch(prepare_batch(lprobs[:LDLT_B64]),
                                                      f64_ldlt))
    viol = _check_round(lprobs[:LDLT_B64], res6_64, "dense_ldlt float64")
    if signed_chol_inv.launches_by_dtype["float64"] <= before:
        raise AssertionError("dense_ldlt float64 batch did not launch K3")
    print(f"[ldlt f64] B={LDLT_B64} all SOLVED in {secs:.3f} s, iterations max "
          f"{int(res6_64.info.iter.max())}, worst KKT {viol:.2e}")
    f64_lu = Settings(kkt_solver=KKTBackend.dense_lu)
    res_lu, secs = _timed(torch, lambda: solve_batch(prepare_batch(lprobs[:64]), f64_lu))
    viol = _check_round(lprobs[:64], res_lu, "dense_lu float64")
    print(f"[lu f64] B=64 all SOLVED in {secs:.3f} s (library LU), iterations max "
          f"{int(res_lu.info.iter.max())}, worst KKT {viol:.2e}")

    # ---- 7. multistage fleet: cyclic reduction through K2
    ms_dims = dict(T=MS_T, D=MS_D, Da=MS_DA, ra=MS_RA, rg=MS_RG)
    seeds = [4 + i for i in range(MS_B)]
    t0 = time.perf_counter()
    data7 = multistage.random_multistage_batch(seeds, **ms_dims)
    rng = np.random.default_rng(2025)
    dc = rng.standard_normal((MS_B, data7.n)) * 1e-3
    data7w = dataclasses.replace(data7, c=data7.c + torch.as_tensor(dc, device="cuda"))
    torch.cuda.synchronize()
    print(f"[ms] prepared {MS_B} problems T={MS_T} D={MS_D} Da={MS_DA} (n={data7.n} "
          f"p={data7.p} m={data7.m}) in {time.perf_counter() - t0:.2f} s")
    kws = [multistage.random_multistage_arrays(seed=s, **ms_dims) for s in seeds]

    def stage_problems(count, shift=None):
        for i in range(count):
            c = None if shift is None else kws[i]["c"] + shift[i]
            yield _stage_problem(multistage, kws[i], c)

    s_ms = Settings(mixed_precision=True)
    solve_batch(index(data7, slice(0, 2)), s_ms)  # warm-up
    _reset_counts()
    cold7, cold7_s = _timed(torch, lambda: solve_batch(data7, s_ms))
    warm7_pt = warm_from_result(cold7)
    warm7, warm7_s = _timed(torch, lambda: solve_batch(data7w, s_ms, warm=warm7_pt))
    k2_launches = dict(chol_inv.apply_launches_by_dtype)
    if not (k2_launches["float32"] > 0 and k2_launches["float64"] > 0):
        raise AssertionError(f"multistage fleet: K2 launches per dtype {k2_launches}")
    for label, res, secs, shift in (("cold", cold7, cold7_s, None),
                                    ("warm", warm7, warm7_s, dc)):
        viol = _check_round(stage_problems(MS_B, shift), res, f"multistage {label}")
        it = res.info.iter.cpu().numpy()
        print(f"[ms {label}] {MS_B}/{MS_B} SOLVED, {MS_B / secs:.1f} solves/s ({secs:.3f} s), "
              f"iterations median {np.median(it):.1f} max {it.max()}, worst KKT "
              f"violation {viol:.2e}; {smi}")
    print(f"[ms] K2 launches in the mixed cold + warm rounds {k2_launches}")
    f64 = Settings()
    n64 = min(64, MS_B)
    before = chol_inv.apply_launches_by_dtype["float64"]
    res7_64, secs = _timed(torch, lambda: solve_batch(index(data7, slice(0, n64)), f64))
    viol = _check_round(stage_problems(n64), res7_64, "multistage float64")
    if chol_inv.apply_launches_by_dtype["float64"] <= before:
        raise AssertionError("multistage float64 batch did not launch K2")
    print(f"[ms f64] B={n64} all SOLVED in {secs:.3f} s, iterations max "
          f"{int(res7_64.info.iter.max())}, worst KKT {viol:.2e}")
    long_dims = dict(ms_dims, T=272)
    if not (not multistage._use_cr(272) and multistage._use_cr(272 // multistage._chunk_count(272) - 1)):
        raise AssertionError("T = 272 does not select chunks with cyclic-reduction interiors")
    before = chol_inv.apply_launches_by_dtype["float64"]
    res_long, secs = _timed(torch, lambda: solve_batch(
        multistage.random_multistage_batch(seeds[:8], **long_dims), f64))
    long_kws = [multistage.random_multistage_arrays(seed=s, **long_dims) for s in seeds[:8]]
    viol = _check_round((_stage_problem(multistage, kw) for kw in long_kws), res_long,
                        "multistage T=272")
    grown = chol_inv.apply_launches_by_dtype["float64"] - before
    if grown <= 0:
        raise AssertionError("the T = 272 batch did not launch K2")
    print(f"[ms T=272] B=8 all SOLVED in {secs:.3f} s (chunked, C={multistage._chunk_count(272)}, "
          f"cyclic-reduction interiors), iterations max {int(res_long.info.iter.max())}, "
          f"K2 float64 launches {grown}, worst KKT {viol:.2e}")
    k2_routes = dict(chol_inv.apply_launches_by_route)
    print(f"[ms] K2 launches by route in the mixed, float64 and T = 272 runs: {k2_routes}")
    if k2_routes != {"small": sum(chol_inv.apply_launches_by_dtype.values()), "resident": 0,
                     "split": 0}:
        raise AssertionError(f"multistage K2 launches by route {k2_routes}: all must be small")

    # ---- 8. SparseSolver: structure detection, solve, update(c), warm solve
    prob0 = _stage_problem(multistage, kws[0])
    csc = {k: sp.csc_matrix(prob0[k]) for k in ("P", "A", "G")}
    ssolver = SparseSolver(Settings(kkt_solver=KKTBackend.multistage), device="cuda")
    t = time.perf_counter()
    ssolver.setup(csc["P"], prob0["c"], csc["A"], prob0["b"], csc["G"],
                  prob0["h_l"], prob0["h_u"])
    setup_s = time.perf_counter() - t
    sd = ssolver._stage_data
    if sd is None or _native._lib is None:
        raise AssertionError("SparseSolver did not detect stages through the C++ library")
    if ssolver.solve() != Status.SOLVED:
        raise AssertionError("SparseSolver did not solve the T = 100 problem")
    it_cold = int(ssolver.result.info.iter)
    dx_cold = (ssolver.result.x.cpu() - res7_64.x[0].cpu()).abs().max().item()
    ssolver.update(c=prob0["c"] + dc[0])
    if ssolver._stage_data.Pd is not sd.Pd:
        raise AssertionError("update(c=...) rebuilt the stage blocks")
    if ssolver.solve(warm_start=True) != Status.SOLVED:
        raise AssertionError("SparseSolver did not solve the updated problem")
    # the same warm solve as a stage batch: warm-started from the batch's
    # own float64 result of problem 0, the point the solver starts from
    ref_w = solve_batch(index(data7w, slice(0, 1)), f64,
                        warm=warm_from_result(index(res7_64, slice(0, 1))))
    dx_warm = (ssolver.result.x.cpu() - ref_w.x[0].cpu()).abs().max().item()
    print(f"[sparse] SparseSolver(multistage) detected T={sd.T} D={sd.D} Da={sd.Da} in "
          f"{setup_s:.2f} s; solve {it_cold} iterations, "
          f"|x - x_batch| {dx_cold:.2e}; update(c) + warm solve "
          f"{int(ssolver.result.info.iter)} iterations, |x - x_batch| {dx_warm:.2e}")
    if not (dx_cold <= 1e-6 and dx_warm <= 1e-6):
        raise AssertionError("SparseSolver disagrees with the stage-batch result")

    # ---- 9. CPU cross-checks and profiles of the new fleets
    _xcheck("dense_ldlt float64, first 4",
            solve_batch(prepare_batch(lprobs[:4], device="cpu"), f64_ldlt),
            index(res6_64, slice(0, 4)), mixed=False)
    _xcheck("dense_ldlt mixed, first 4",
            solve_batch(prepare_batch(lprobs[:4], device="cpu"), s_ldlt),
            index(cold6, slice(0, 4)), mixed=True)
    data7_cpu = to_device(index(data7, slice(0, 4)), "cpu")
    _xcheck("multistage float64, first 4", solve_batch(data7_cpu, f64),
            index(res7_64, slice(0, 4)), mixed=False)
    _xcheck("multistage mixed, first 4", solve_batch(data7_cpu, s_ms),
            index(cold7, slice(0, 4)), mixed=True)
    _profile_round(torch, "ldlt warm",
                   lambda: solve_batch(data6w, s_ldlt, warm=warm6_pt), warm6_s, smi,
                   ("signed_chol_inv_resident_kernel",))
    _profile_round(torch, "ms warm",
                   lambda: solve_batch(data7w, s_ms, warm=warm7_pt), warm7_s, smi,
                   ("chol_inv_apply_small_kernel",))
    for entry in kernels:
        if entry["kernel_route"] in ("resident", "split") and entry["name"].startswith(
                "chol_inv_apply_"):
            continue  # phases 17 and 18 count the resident and split routes' launches
        for prefix, counts in (("chol_inv_apply_", k2_launches),
                               ("signed_chol_inv_", k3_launches)):
            if entry["name"].startswith(prefix):
                entry["launches"] = counts[entry["name"].removeprefix(prefix)]

    # ---- 10-13. differentiable fleets, SQP rounds and compaction, timings
    # and the host route
    t_new = time.perf_counter()
    k1 = _diff_dense_fleet(torch, smi)
    if not (k1["resident"] > 0 and k1["cluster"] == 0):
        raise AssertionError(f"dense differentiable forward: K1 launches by route {k1}")
    k2b = _diff_stage_fleet(torch, smi, data7)
    if not (k2b["small"] > 0 and k2b["resident"] == k2b["split"] == 0):
        raise AssertionError(f"stage backward: K2 launches by route {k2b}; the adjoint factor "
                             f"must launch the small kernel")
    sq = _sqp_and_compaction(torch, smi, problems, moved, data, data_w, cold, warm_pt, settings)
    if not (sq["k1_sqp"]["resident"] > 0 and sq["k1_compact"]["resident"] > 0):
        raise AssertionError("SQP rounds or compaction did not launch K1")
    _timings_and_host_route(torch, smi, problems, moved)
    print(f"[phases 10-13] {time.perf_counter() - t_new:.1f} s")

    # ---- 14. horizon-sharded solves and batch sharding (torch.distributed)
    t_new = time.perf_counter()
    hz = _horizon_phase(
        torch, smi,
        dict(data=data7, data_w=data7w, settings=s_ms, cold=cold7, warm=warm7,
             cold_s=cold7_s, warm_s=warm7_s, dc=dc,
             problems=lambda shift: stage_problems(MS_B, shift)),
        dict(data=data, settings=settings, cold=cold, cold_s=cold_s))
    for entry in kernels:
        if entry["kernel_route"] == "small":
            dtype = entry["name"].removeprefix("chol_inv_apply_")
            entry["horizon_launches"] = hz["k2"][dtype]
            entry["horizon_rank_launches"] = {world: [r[dtype] for r in ranks]
                                              for world, ranks in hz["k2_ranks"].items()}
    print(f"[phase 14] {time.perf_counter() - t_new:.1f} s")

    # ---- 15. the C interface and the examples
    t_new = time.perf_counter()
    capi = _capi_phase(torch, smi, problems[0], moved[0]["c"], prob0, prob0["c"] + dc[0])
    for entry in kernels:
        if entry["kernel_route"] in ("cluster", "split") or entry["name"].startswith(
                "chol_inv_apply_resident_"):
            continue  # phase 15 runs n = 128 (K1's resident route) and D = 8 (K2's small)
        for prefix, kernel, cases in (("chol_inv_apply_", "K2", ("multistage",)),
                                      ("signed_chol_inv_", "K3", ("ldlt",)),
                                      ("chol_inv_", "K1", ("chol", "mixed"))):
            if entry["name"].startswith(prefix):
                dtype = entry["name"].removeprefix(prefix)
                entry["capi_launches"] = sum(capi[c][f"{kernel}_dtype"][dtype] for c in cases)
                break
    print(f"[phase 15] {time.perf_counter() - t_new:.1f} s")

    # ---- 16. the n = 256 dense fleet on K1's cluster route
    t_new = time.perf_counter()
    n256 = _dense256_phase(torch, smi)
    for entry in kernels:
        if entry["kernel_route"] == "cluster":
            dtype = entry["name"].removeprefix("chol_inv_cluster_")
            entry["launches"] = n256["by_dtype"][dtype]
            entry["n256_launches_by_route"] = n256["by_route"]
            entry["n256_launches_by_cluster"] = n256["by_cluster"]
    print(f"[phase 16] {time.perf_counter() - t_new:.1f} s")

    # ---- 17. the D = 48 multistage fleet on K2's resident route
    t_new = time.perf_counter()
    ms48 = _wide_stage_phase(torch, smi, "ms48", MS48_B, MS48_D, MS48_B64, 4000, 2027,
                             "resident", K2_MS48, ("chol_inv_apply_resident_kernel",))
    for entry in kernels:
        if entry["kernel_route"] == "resident" and entry["name"].startswith("chol_inv_apply_"):
            entry["launches"] = ms48["by_dtype"][entry["name"].removeprefix(
                "chol_inv_apply_resident_")]
            entry["ms48_launches_by_route"] = ms48["by_route"]
    print(f"[phase 17] {time.perf_counter() - t_new:.1f} s")

    # ---- 18. the D = 144 multistage fleet on K2's split route
    t_new = time.perf_counter()
    ms144 = _wide_stage_phase(torch, smi, "ms144", MS144_B, MS144_D, MS144_B64, 5000, 2028,
                              "split", K2_MS144,
                              ("chol_inv_resident_kernel", "chol_inv_apply_product_kernel"))
    for entry in kernels:
        if entry["kernel_route"] == "split":
            entry["launches"] = ms144["by_dtype"][entry["name"].removeprefix(
                "chol_inv_apply_split_")]
            entry["ms144_launches_by_route"] = ms144["by_route"]
            entry["ms144_factors_by_route"] = ms144["by_factor"]
    print(f"[phase 18] {time.perf_counter() - t_new:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(f"[device] {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
