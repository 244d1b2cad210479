"""The tiled likelihood kernels' share of their roofline: the least time of
the likelihood's forward and backward work per gradient
(``work.gradient_work``) over the device time, in the traced window, of the
kernels named here (K3 and K4 with its scatter), per gradient."""

KERNELS = ("tiled_fwd_kernel", "tiled_bwd_kernel", "tiled_scatter_kernel")


def read(rec):
    if rec.trace is None:
        return None
    device_s = rec.trace.device_s(KERNELS)
    if device_s <= 0 or not rec.traced_grad_evals:
        return None
    least_s, _ = rec.work.least_s()
    return 100.0 * least_s * rec.traced_grad_evals / device_s
