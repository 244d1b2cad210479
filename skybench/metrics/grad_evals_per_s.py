"""Joint value-and-gradient evaluations the chains' own transitions used
(leapfrog steps times chains) over the window's seconds."""


def read(rec):
    return rec.window["chain_grad_evals"] / rec.window["seconds"]
