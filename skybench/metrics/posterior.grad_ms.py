"""Mean host ms of one call of the program's ``inference.hmc.value_and_grad``
on the window's last states, each call ended by a device synchronize."""


def read(rec):
    return rec.grad_ms
