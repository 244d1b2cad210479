"""Survey-realism field-scale accuracy scene (counterpart of
``celeste_tpu/bench/field_scale.py``, copied on the port's synthetic data
and catalog, whose counts equal the JAX package's bitwise).

The config ``field_survey``'s scene: a 256x1024 frame —
SDSS-frame aspect at quarter height — carrying ~60 sources (stars +
~1/7 galaxies, fluxes spanning bright to near the detection limit) plus
four deliberate blended pairs at 2.6-3.4'' separation, i.e. inside the
``link_radius_px`` linking scale, so the pipeline must fit joint groups,
not just isolated cutouts.

The accuracy contract (SURVEY.md C17 — the reference's photoObj
comparison, run against synthetic truth): completeness and purity >= 0.9
at the detection SNR, and astrometric/photometric posterior z-score RMS
in a calibrated band.
"""

from __future__ import annotations

import numpy as np
import torch

from celeste_tpu_torch.data.synthetic import (
    galaxy_source,
    make_synthetic_stamp,
    star_source,
)

__all__ = ["make_survey_scene", "survey_scene_cfg", "accuracy_report", "cluster_specs",
           "cluster_group"]

_COSD = np.cos(np.deg2rad(10.0))


def make_survey_scene(shape=(256, 1024), n_isolated=56, seed=11,
                      flux_lo=14.0, flux_hi=70.0, device="cpu"):
    """Returns ``(scene, srcs)``: a single-band (r) survey-scale frame, its
    stamp on ``device``.

    Sources sit on a rejection-sampled layout with >=18 px separation
    (isolated set) plus four blended pairs at fixed positions; fluxes are
    uniform in [flux_lo, flux_hi] — at the synthetic sky/gain defaults
    the faint end sits a few sigma above ``detection_snr_min=5`` so the
    completeness gate tests detection, not luck.
    """
    h, w = shape
    rng = np.random.default_rng(seed)
    px = rng.uniform(14, w - 14, n_isolated)
    py = rng.uniform(10, h - 10, n_isolated)
    keep = []
    for x, y in zip(px, py):
        if all((x - a) ** 2 + (y - b) ** 2 > 18 ** 2 for a, b in keep):
            keep.append((x, y))

    def to_u(x, y):
        de, dn = (x - (w - 1) / 2) * 0.396, (y - (h - 1) / 2) * 0.396
        return (30 + de / 3600 / _COSD, 10 + dn / 3600)

    srcs = []
    for i, (x, y) in enumerate(keep):
        f = float(rng.uniform(flux_lo, flux_hi))
        if i % 7 == 3:
            # galaxies get ~1.6x flux: extended light spreads over more
            # pixels, so equal-flux galaxies sit lower in peak SNR
            srcs.append(galaxy_source(
                u=to_u(x, y), flux_r=1.6 * f,
                sigma=float(rng.uniform(0.8, 1.6)),
                ab=float(rng.uniform(0.5, 0.9)),
                phi=float(rng.uniform(0.0, np.pi))))
        else:
            srcs.append(star_source(u=to_u(x, y), flux_r=f))
    # blended pairs at frame-fraction anchors so the scene scales with
    # ``shape``; at the 256x1024 default these are the pixel anchors
    # (150,60 / 500,200 / 800,90 / 300,128)
    for fx, fy, sep_as in ((150 / 1024, 60 / 256, 3.0),
                           (500 / 1024, 200 / 256, 2.6),
                           (800 / 1024, 90 / 256, 3.4),
                           (300 / 1024, 128 / 256, 2.8)):
        bx, by, sep_px = fx * w, fy * h, sep_as / 0.396
        srcs.append(star_source(u=to_u(bx, by), flux_r=55.0))
        srcs.append(star_source(u=to_u(bx + sep_px, by), flux_r=40.0))
    scene = make_synthetic_stamp(srcs, shape=(h, w), bands=(2,), seed=99, device=device)
    return scene, srcs


def survey_scene_cfg(**over):
    """FieldConfig sized for the survey scene: sampling budgets follow the
    test-lane sizes (recovery-gate MC error, not ESS)."""
    from celeste_tpu_torch.field import FieldConfig

    base = dict(sample=True, seed=6, n_chains=8, probe_warmup=32,
                probe_steps=16, n_warmup=48, n_steps=96, max_leapfrog=16,
                map_steps=150, type_switch=False, group_cut=32,
                group_margin_px=8)
    base.update(over)
    return FieldConfig(**base)


def accuracy_report(catalog, scene, srcs):
    """The photoObj-style report for this scene (celeste_tpu_torch.catalog)."""
    from celeste_tpu_torch.catalog import catalog_accuracy, reference_from_sources

    ref = reference_from_sources(srcs, scene.wcs, band_slots=[2])
    return catalog_accuracy(catalog, ref, max_sep_arcsec=1.0)


def cluster_specs():
    """A galaxy cluster on a 64x64 r-band frame: 10 stars and 10 galaxies
    on a 5 x 4 grid 5 pixels apart (2.0''), inside the field's default
    ``link_radius_px`` = 12 of each other, so they link into one fit group
    of 20 sources (960 components a row).  (kind, constructor keywords)
    pairs, for either package's ``star_source`` and ``galaxy_source``."""
    rng = np.random.default_rng(20)
    specs = []
    for i in range(20):
        x, y = 21.5 + 5.0 * (i % 5), 24.0 + 5.0 * (i // 5)
        u = (30.0 + (x - 31.5) * 0.396 / 3600 / _COSD, 10.0 + (y - 31.5) * 0.396 / 3600)
        if i % 2:
            specs.append(("galaxy", dict(u=u, flux_r=float(rng.uniform(40.0, 80.0)),
                                         sigma=float(rng.uniform(0.8, 1.6)),
                                         ab=float(rng.uniform(0.5, 0.9)),
                                         phi=float(rng.uniform(0.0, np.pi)))))
        else:
            specs.append(("star", dict(u=u, flux_r=float(rng.uniform(20.0, 50.0)))))
    return specs


CLUSTER_SEED = 37


def cluster_group(device="cpu"):
    """The cluster frame as one fit group at the field's layout: the scene,
    the sources' pixel positions [20, 2], their rectangular states at the
    truth [20, 7] (one band: a star's 3 slots then zeros; a galaxy's
    position, log-flux, logit theta, log sigma, logit ab, phi), their kinds
    (True: star), and the frame's pixel set (px, py, counts, sky, mask),
    each [P] NumPy float32, the sky as the group's effective sky."""
    srcs = [star_source(**kw) if kind == "star" else galaxy_source(**kw)
            for kind, kw in cluster_specs()]
    scene = make_synthetic_stamp(srcs, shape=(64, 64), bands=(2,), seed=CLUSTER_SEED,
                                 device=device)
    stamp = scene.stamps[0]
    rects = np.zeros((len(srcs), 7), np.float32)
    is_star = np.array([kind == "star" for kind, _ in cluster_specs()])
    for i, s in enumerate(srcs):
        rects[i, :3] = np.concatenate([scene.wcs.equa2duas(s["u"]), [np.log(s["flux"][2])]])
        if not is_star[i]:
            t, ab = s["theta_dev"], s["ab"]
            rects[i, 3:] = [np.log(t / (1 - t)), np.log(s["sigma"]), np.log(ab / (1 - ab)),
                            s["phi"]]
    pos = np.stack([stamp.duas2pixel(torch.as_tensor(scene.wcs.equa2duas(s["u"]),
                                                     dtype=torch.float32, device=device))
                    .cpu().numpy() for s in srcs]).astype(np.float64)
    px, py = stamp.pixel_grid()
    pixels = tuple(t.reshape(-1).cpu().numpy().astype(np.float32)
                   for t in (px, py, stamp.counts, stamp.sky, stamp.mask))
    return scene, pos, rects, is_star, pixels
