"""k2_roofline.warm: the roofline time of the traced window's K2 work
(Cholesky with inverse and apply: each launch factors N blocks of n x n
and applies them to n x r right-hand sides; launches by shape from the
program's counter ``chol_inv.apply_launches_by_shape``, keyed
``"<dtype>:<N>x<n>x<r>"``, each priced by ``roofline.apply_s``) over the
device time of K2's kernels, in %.  A cyclic-reduction level launches
N = B x its odd blocks, so the shapes come from the counter, not from the
configuration."""

from gpubench import roofline

COUNTER = "chol_inv.apply_launches_by_shape"
# K2's kernels: the small and resident routes, and the split route's product
KERNELS = ("chol_inv_apply_small_kernel", "chol_inv_apply_resident_kernel",
           "chol_inv_apply_product_kernel")
# the split route's factor runs K1's kernels: theirs too where the window
# launched one
SPLIT_FACTORS = "chol_inv.apply_factor_launches_by_route"
FACTOR_KERNELS = ("chol_inv_resident_kernel", "chol_inv_cluster_kernel")


def read(run):
    if run.trace is None:
        return None
    work = 0.0
    for key, k in run.counters.get(COUNTER, {}).items():
        dtype, shape = key.split(":")
        N, n, r = (int(v) for v in shape.split("x"))
        work += k * roofline.apply_s(N, n, r, dtype)
    names = KERNELS + (FACTOR_KERNELS if any(run.counters.get(SPLIT_FACTORS, {}).values())
                       else ())
    seconds = sum(e.end - e.start for e in run.trace.kernels(names)) * 1e-9
    if not seconds or not work:
        return None
    return 100.0 * work / seconds
