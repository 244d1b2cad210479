"""The observed field of a configuration: the fixed layout from its file and
the Poisson counts drawn from the seed, in float64 NumPy.  Both sides take
their pixel data from here: the program through its public constructors,
the reference as it is."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from skybench.reference.renderer import expected_counts
from skybench.reference.support import block_support_radii


@dataclass
class Field:
    """kinds [S]; ``pos_px`` [S, 2] true pixel positions; per band (in the
    configuration's order, flux slot i for band i): ``counts`` [nb, H, W],
    ``sky`` [nb], ``iota`` [nb], ``mask`` [nb, H, W], ``psf_w`` and
    ``psf_var`` [nb, K]; ``jac`` [2, 2] pixels per arcsec of (east, north)
    offset and ``p0`` [2] the pixel of the reference point; ``truth`` [D]
    the unconstrained state of the true sources; ``radii`` [S, N_GAL] the
    support radii of the component blocks."""

    kinds: tuple
    bands: tuple
    pos_px: np.ndarray
    counts: np.ndarray
    sky: np.ndarray
    iota: np.ndarray
    mask: np.ndarray
    psf_w: np.ndarray
    psf_var: np.ndarray
    jac: np.ndarray
    p0: np.ndarray
    truth: np.ndarray
    radii: np.ndarray

    @property
    def n_bands(self):
        return len(self.bands)

    @property
    def shape(self):
        return tuple(self.counts.shape[1:])

    def block_widths(self):
        nb = self.n_bands
        return [2 + nb if k == "star" else 6 + nb for k in self.kinds]

    @property
    def dim(self):
        return sum(self.block_widths())


def _truth(sources, bands, p0, pixel_scale):
    parts = []
    for s in sources:
        du = (np.array([s["x_px"], s["y_px"]]) - p0) * pixel_scale
        head = [du, np.log([s["flux_nmgy"][b] for b in bands])]
        if s["kind"] == "galaxy":
            th, ab = s["theta_dev"], s["ab"]
            head.append([np.log(th / (1 - th)), np.log(s["sigma_arcsec"]),
                         np.log(ab / (1 - ab)), s["phi"]])
        parts.append(np.concatenate(head))
    return np.concatenate(parts)


def make_field(config: dict, rng: np.random.Generator) -> Field:
    """The configuration's field with counts drawn from ``rng``, band by
    band in the configuration's order."""
    f = config["field"]
    h, w = f["shape"]
    scale = float(f["pixel_scale_arcsec"])
    bands = tuple(int(b) for b in f["bands"])
    nb = len(bands)
    jac = np.eye(2) / scale
    p0 = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
    psf_w = np.array([f["psf_per_band"]["weights"]] * nb, np.float64)
    psf_var = np.array([f["psf_per_band"]["var_px2"]] * nb, np.float64)
    sources = config["sources"]
    counts = np.stack([
        rng.poisson(expected_counts(sources, b, (h, w), f["sky"], f["iota"], psf_w[i],
                                    psf_var[i], jac)).astype(np.float64)
        for i, b in enumerate(bands)])
    kinds = tuple(s["kind"] for s in sources)
    sup = config["posterior"]["support"]
    radii = block_support_radii(kinds, psf_sigma_px=float(np.sqrt(psf_var.max())),
                                gal_sigma_px=sup["gal_sigma_upper_arcsec"] / scale,
                                rel_eps=sup["rel_eps"], slack_px=sup["slack_px"])
    return Field(kinds=kinds, bands=bands,
                 pos_px=np.array([[s["x_px"], s["y_px"]] for s in sources], np.float64),
                 counts=counts, sky=np.full(nb, float(f["sky"])),
                 iota=np.full(nb, float(f["iota"])), mask=np.ones_like(counts),
                 psf_w=psf_w, psf_var=psf_var, jac=jac, p0=p0,
                 truth=_truth(sources, bands, p0, scale), radii=radii)
