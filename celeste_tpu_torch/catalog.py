"""Catalog cross-matching and accuracy metrics (counterpart of
``celeste_tpu/catalog.py``, copied: NumPy only, so both packages score a
catalog alike).

Match a posterior catalog (``pipeline.CatalogEntry`` rows from
``run_pipeline``) against a reference catalog -- the ground truth of a
synthetic scene, or an external catalog's rows -- and report detection
completeness/purity, star/galaxy classification accuracy, astrometric and
photometric residuals, and posterior CALIBRATION (are the reported
posterior widths honest?).

Everything here is small host-side NumPy: catalogs are thousands of rows,
not pixels -- there is nothing for the device to do.

Conventions
-----------
Positions are tangent-plane offsets in arcsec (east, north) relative to
the frame's reference point -- the same ``du`` frame ``CatalogEntry``
uses (``HostWcs.equa2duas``).  Reference rows are plain dicts with keys
``du`` ([2] arcsec), ``flux`` ([n_bands] nanomaggies in the *modeled*
band slots) and optionally ``kind`` ("star"/"galaxy").
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "reference_from_sources",
    "match_catalogs",
    "catalog_accuracy",
]


def reference_from_sources(sources: Sequence[dict], wcs,
                           band_slots: Optional[Sequence[int]] = None) -> List[dict]:
    """Reference rows from synthetic ground-truth source dicts
    (``data.synthetic.star_source``/``galaxy_source`` style: ``u`` in
    ra/dec degrees, ``flux`` per-band over the full band set).

    ``band_slots``: indices into each source's ``flux`` vector selecting
    the modeled bands, in catalog order (e.g. ``[2]`` for an r-only run —
    the ``band=`` the pipeline was run with).  None keeps all slots.
    """
    rows = []
    for s in sources:
        flux = np.asarray(s["flux"], np.float64)
        if band_slots is not None:
            flux = flux[np.asarray(band_slots, int)]
        rows.append({
            "du": np.asarray(wcs.equa2duas(s["u"]), np.float64),
            "flux": flux,
            "kind": s.get("type", "star"),
        })
    return rows


def match_catalogs(cat_du, ref_du, max_sep_arcsec: float = 1.0):
    """Greedy closest-pair matching between two position lists.

    Pairs are consumed in ascending separation (each row used at most
    once), dropping pairs beyond ``max_sep_arcsec`` — the standard
    symmetric cross-match: no catalog row claims a reference row that a
    strictly closer catalog row also wants.

    Returns ``(pairs, unmatched_cat, unmatched_ref)`` where ``pairs`` is a
    list of ``(i_cat, j_ref, sep_arcsec)``.
    """
    cat_du = np.atleast_2d(np.asarray(cat_du, np.float64))
    ref_du = np.atleast_2d(np.asarray(ref_du, np.float64))
    n_c = 0 if cat_du.size == 0 else cat_du.shape[0]
    n_r = 0 if ref_du.size == 0 else ref_du.shape[0]
    if n_c == 0 or n_r == 0:
        return [], list(range(n_c)), list(range(n_r))
    sep = np.linalg.norm(cat_du[:, None, :] - ref_du[None, :, :], axis=-1)
    order = np.argsort(sep, axis=None)
    used_c, used_r, pairs = set(), set(), []
    for flat in order:
        i, j = np.unravel_index(flat, sep.shape)
        if sep[i, j] > max_sep_arcsec:
            break
        if i in used_c or j in used_r:
            continue
        used_c.add(int(i))
        used_r.add(int(j))
        pairs.append((int(i), int(j), float(sep[i, j])))
    unmatched_cat = [i for i in range(n_c) if i not in used_c]
    unmatched_ref = [j for j in range(n_r) if j not in used_r]
    return pairs, unmatched_cat, unmatched_ref


def catalog_accuracy(catalog, reference: Sequence[dict],
                     max_sep_arcsec: float = 1.0) -> dict:
    """Accuracy report of a posterior ``catalog`` against ``reference``.

    Metrics (all over the matched pairs unless noted):

    - ``completeness`` = matched / n_reference; ``purity`` = matched /
      n_catalog (1 - spurious fraction) — over ALL rows;
    - ``kind_accuracy``: fraction of matches whose star/galaxy call
      agrees with the reference (None when the reference carries no kind);
    - ``pos_rms_arcsec`` and ``pos_bias_arcsec`` ([2], east/north):
      astrometric scatter and systematic offset;
    - ``flux_rel_bias`` / ``flux_rel_scatter``: mean and RMS of
      (flux_mean - flux_ref)/flux_ref pooled over the modeled bands;
    - calibration z-scores: ``pos_z_rms`` and ``flux_z_rms`` are the RMS
      of (posterior mean - reference)/posterior std.  ≈1 means the
      reported uncertainties are honest; ≫1 overconfident, ≪1
      conservative.  Entries with zero reported std (e.g. MAP-only rows)
      are excluded from z statistics.

    Returns the metric dict plus the raw ``matches`` / ``spurious`` /
    ``missed`` index lists for drill-down.
    """
    cat_du = [np.asarray(e.du_mean, np.float64) for e in catalog]
    ref_du = [np.asarray(r["du"], np.float64) for r in reference]
    pairs, spurious, missed = match_catalogs(
        cat_du if cat_du else np.zeros((0, 2)),
        ref_du if ref_du else np.zeros((0, 2)),
        max_sep_arcsec=max_sep_arcsec)

    n_cat, n_ref, n_match = len(catalog), len(reference), len(pairs)
    out = {
        "n_catalog": n_cat, "n_reference": n_ref, "n_matched": n_match,
        "completeness": (n_match / n_ref) if n_ref else None,
        "purity": (n_match / n_cat) if n_cat else None,
        "matches": pairs, "spurious": spurious, "missed": missed,
        "max_sep_arcsec": float(max_sep_arcsec),
    }
    if n_match == 0:
        out.update({"kind_accuracy": None, "pos_rms_arcsec": None,
                    "pos_bias_arcsec": None, "flux_rel_bias": None,
                    "flux_rel_scatter": None, "pos_z_rms": None,
                    "flux_z_rms": None})
        return out

    d_pos, z_pos, kinds_ok = [], [], []
    rel, z_flux = [], []
    for i, j, _ in pairs:
        e, r = catalog[i], reference[j]
        du_e = np.asarray(e.du_mean, np.float64)
        du_r = np.asarray(r["du"], np.float64)
        d_pos.append(du_e - du_r)
        du_std = np.asarray(e.du_std, np.float64)
        if np.all(du_std > 0):
            z_pos.append((du_e - du_r) / du_std)
        if r.get("kind") is not None:
            kinds_ok.append(e.kind == r["kind"])
        f_e = np.asarray(e.flux_mean, np.float64)
        f_r = np.asarray(r["flux"], np.float64)
        n_b = min(f_e.shape[0], f_r.shape[0])
        f_e, f_r = f_e[:n_b], f_r[:n_b]
        ok = f_r > 0
        rel.extend(((f_e - f_r) / f_r)[ok].tolist())
        f_std = np.asarray(e.flux_std, np.float64)[:n_b]
        okz = ok & (f_std > 0)
        z_flux.extend(((f_e - f_r) / np.where(okz, f_std, 1.0))[okz].tolist())

    d_pos = np.asarray(d_pos)
    out["pos_rms_arcsec"] = float(np.sqrt(np.mean(np.sum(d_pos ** 2, axis=1))))
    out["pos_bias_arcsec"] = d_pos.mean(axis=0).tolist()
    out["kind_accuracy"] = (float(np.mean(kinds_ok)) if kinds_ok else None)
    out["flux_rel_bias"] = (float(np.mean(rel)) if rel else None)
    out["flux_rel_scatter"] = (float(np.sqrt(np.mean(np.square(rel))))
                               if rel else None)
    out["pos_z_rms"] = (float(np.sqrt(np.mean(np.square(z_pos))))
                        if z_pos else None)
    out["flux_z_rms"] = (float(np.sqrt(np.mean(np.square(z_flux))))
                         if z_flux else None)
    return out
