"""Device kernels and copies in the traced window over the value-and-gradient
evaluations it computed (the leapfrog steps of its sampler steps)."""


def read(rec):
    if rec.trace is None or not rec.traced_grad_evals:
        return None
    return rec.trace.n_ops / rec.traced_grad_evals
