"""The program's side of a field: the pixel data of :mod:`skybench.reference.field`
handed to the program through its public constructors (``model.stamp.Stamp``,
``mog.isotropic``, ``parallel.crowded``), and the joint log density the
samplers run on."""

from __future__ import annotations

import torch


def port_logdensity(field, config: dict, device):
    """(log density [B, D] -> [B] of the tiled joint posterior, its
    ``TiledStampData`` list, the true state [D] as float32 on ``device``)."""
    from celeste_tpu_torch.model.stamp import Stamp
    from celeste_tpu_torch.mog import isotropic
    from celeste_tpu_torch.parallel.crowded import CrowdedScene, make_tiled_crowded_logdensity

    kw = dict(dtype=torch.float32, device=device)
    h, w = field.shape
    stamps = []
    for i, band in enumerate(field.bands):
        k = field.psf_w.shape[1]
        stamps.append(Stamp(counts=torch.as_tensor(field.counts[i], **kw),
                            sky=torch.full((h, w), float(field.sky[i]), **kw),
                            iota=torch.tensor(float(field.iota[i]), **kw),
                            mask=torch.as_tensor(field.mask[i], **kw),
                            psf=isotropic(field.psf_w[i], [[0.0, 0.0]] * k, field.psf_var[i],
                                          device),
                            wcs_A=torch.as_tensor(field.jac, **kw),
                            wcs_p0=torch.as_tensor(field.p0, **kw), band=band))
    scene = CrowdedScene(kinds=field.kinds, n_bands=field.n_bands)
    post = config["posterior"]
    multi = field.n_bands > 1
    # a field of one kind takes a radius a source (its first block's)
    radii = field.radii if len(set(field.kinds)) > 1 else field.radii[:, 0]
    logd, data = make_tiled_crowded_logdensity(
        scene, stamps if multi else stamps[0],
        band=list(range(field.n_bands)) if multi else 0, positions_px=field.pos_px,
        radii_px=radii, n_buckets=post["n_buckets"], centered=post["centered"])
    return logd, (data if multi else [data]), torch.as_tensor(field.truth, **kw)
