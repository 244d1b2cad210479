"""The whole gradient step's share of the card's peak: the least time the
counted work of one joint value-and-gradient at the cell's chains could
take (``work.gradient_work``), over ``posterior.grad_ms``."""


def read(rec):
    if not rec.grad_ms:
        return None
    least_s, _ = rec.work.least_s()
    return 100.0 * least_s / (rec.grad_ms * 1e-3)
