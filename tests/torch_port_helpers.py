"""Shared helpers of the ``test_torch_*`` files: move one JAX-package scene
or source into the PyTorch port through ``celeste_tpu_torch.interop``, as
NumPy arrays, and keep each module's torch ops on one thread."""

import numpy as np
import pytest
import torch

from celeste_tpu_torch.interop import (
    galaxy_params_from_numpy,
    stamp_from_numpy,
    star_params_from_numpy,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch ops on one thread: the suite runs several worker
    processes at once, and torch's default pool of one thread per core then
    oversubscribes the machine, slowing the many small ops of the samplers
    by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_stamp(jstamp, device="cpu"):
    """The port's Stamp holding the same arrays as a JAX-package Stamp."""
    return stamp_from_numpy(
        counts=np.asarray(jstamp.counts), sky=np.asarray(jstamp.sky),
        iota=np.asarray(jstamp.iota), mask=np.asarray(jstamp.mask),
        psf_w=np.asarray(jstamp.psf.w), psf_mu=np.asarray(jstamp.psf.mu),
        psf_cov=np.asarray(jstamp.psf.cov), wcs_A=np.asarray(jstamp.wcs_A),
        wcs_p0=np.asarray(jstamp.wcs_p0), band=int(jstamp.band), device=device)


def source_base_vector(scene, kind):
    """The true unconstrained vector of a scene's first source (5 bands)."""
    src = scene.sources[0]
    parts = [scene.wcs.equa2duas(src["u"]), np.log(src["flux"])]
    if kind == "galaxy":
        t, ab = src["theta_dev"], src["ab"]
        parts.append([np.log(t / (1 - t)), np.log(src["sigma"]), np.log(ab / (1 - ab)),
                      src["phi"]])
    return np.concatenate(parts)


def source_vecs(scene, kind, n, scale, seed):
    """[n, D] float32 vectors scattered around the truth, drawn with numpy."""
    base = source_base_vector(scene, kind)
    rng = np.random.default_rng(seed)
    return (base[None, :] + scale * rng.normal(size=(n, base.size))).astype(np.float32)


def port_params(src, wcs, kind):
    """The port's params of an oracle-style source dict at its truth."""
    du = wcs.equa2duas(src["u"])
    if kind == "star":
        return star_params_from_numpy(du, src["flux"])
    return galaxy_params_from_numpy(du, src["flux"], src["theta_dev"], src["sigma"],
                                    src["ab"], src["phi"])
