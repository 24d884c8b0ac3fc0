"""k1_roofline.warm: the roofline time of the traced window's Cholesky-with-
inverse work on the condensed KKT matrices (each launch factors the
batch's B n x n matrices; launches by dtype from the program's counter
``chol_inv.launches_by_dtype``) over the device time of the kernels that
did it, in %."""

from gpubench import roofline

# the kernels whose device time is summed: K1's resident and cluster routes
KERNELS = ("chol_inv_resident_kernel", "chol_inv_cluster_kernel")


def read(run):
    if run.trace is None:
        return None
    launches = run.counters.get("launches_by_dtype", {})
    seconds = sum(e.end - e.start for e in run.trace.kernels(KERNELS)) * 1e-9
    if not seconds or not sum(launches.values()):
        return None
    B, n = run.batch, run.config["sizes"]["dim"]
    work = sum(k * roofline.factor_s(B, n, dtype) for dtype, k in launches.items())
    return 100.0 * work / seconds
