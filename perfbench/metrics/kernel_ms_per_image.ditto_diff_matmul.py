"""kernel_ms_per_image.ditto_diff_matmul: the difference GEMM's device time
in the window over the images completed there, in ms."""
from perfbench.harness import KERNELS


def read(run):
    if run.trace is None or not run.images:
        return None
    kernel_s, n = run.trace.kernel_s(run.t_open, run.t_close, KERNELS["ditto_diff_matmul"])
    return 1e3 * kernel_s / run.images if n else None
