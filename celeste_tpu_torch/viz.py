"""Plotting utilities (counterpart of ``celeste_tpu/viz.py``): model-vs-data
stamps, traces, posterior marginals, photo-z posteriors and the catalog
comparison.  Headless (Agg); every function returns the Figure and
optionally writes a PNG.  Any tensor given, on any device, is read through
``.cpu()``."""

from __future__ import annotations

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402


def _np(x, dtype=None):
    """A NumPy array of ``x``: a tensor through ``.cpu()``, else as it is."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def plot_model_vs_data(stamp, lam, path: str | None = None):
    """Three-panel: observed counts, model expectation lambda, Pearson
    residual (obs - lam)/sqrt(lam)."""
    counts = _np(stamp.counts, np.float64)
    lam = _np(lam, np.float64)
    resid = (counts - lam) / np.sqrt(np.maximum(lam, 1e-9))
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, img, title in zip(
        axes, [counts, lam, resid], ["observed counts", "model lambda", "pearson resid"]
    ):
        vmax = np.percentile(img, 99.5) if title != "pearson resid" else 4
        vmin = img.min() if title != "pearson resid" else -4
        im = ax.imshow(img, origin="lower", cmap="viridis" if title != "pearson resid"
                       else "coolwarm", vmin=vmin, vmax=vmax)
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_traces(samples, names=None, path: str | None = None, max_chains: int = 8):
    """Per-parameter trace plots over chains: [n_chains, n_steps, D]."""
    s = _np(samples)
    d = s.shape[-1]
    names = names or [f"p{i}" for i in range(d)]
    fig, axes = plt.subplots(d, 1, figsize=(8, 1.6 * d), sharex=True, squeeze=False)
    for i in range(d):
        for c in range(min(s.shape[0], max_chains)):
            axes[i, 0].plot(s[c, :, i], lw=0.5, alpha=0.7)
        axes[i, 0].set_ylabel(names[i], fontsize=8)
    axes[-1, 0].set_xlabel("step")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_marginals(samples, truth=None, names=None, path: str | None = None):
    """Histogram per parameter with optional ground-truth line."""
    s = _np(samples).reshape(-1, _np(samples).shape[-1])
    d = s.shape[1]
    names = names or [f"p{i}" for i in range(d)]
    ncol = min(d, 4)
    nrow = (d + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(3 * ncol, 2.4 * nrow), squeeze=False)
    for i in range(d):
        ax = axes[i // ncol, i % ncol]
        ax.hist(s[:, i], bins=50, density=True, alpha=0.8)
        if truth is not None:
            ax.axvline(_np(truth)[i], color="r", lw=1.5)
        ax.set_title(names[i], fontsize=9)
    for j in range(d, nrow * ncol):
        axes[j // ncol, j % ncol].axis("off")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_photo_z(z_samples, z_true=None, path: str | None = None, z_max=6.0):
    """Redshift posterior histogram (the reference's headline quasar plot)."""
    z = _np(z_samples).ravel()
    fig, ax = plt.subplots(figsize=(7, 3.2))
    ax.hist(z, bins=np.linspace(0, z_max, 150), density=True, alpha=0.85)
    if z_true is not None:
        ax.axvline(z_true, color="r", lw=1.5, label=f"z_true={z_true:.2f}")
        ax.legend()
    ax.set_xlabel("redshift z")
    ax.set_ylabel("posterior density")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_catalog_match(catalog, reference, report, path: str | None = None):
    """Two-panel catalog-vs-reference comparison (the reference's
    photoObj-style validation plot; SURVEY C17): matched positions with
    residual whiskers, and per-match flux ratio with 1-sigma posterior
    error bars.  ``report`` is ``celeste_tpu_torch.catalog.catalog_accuracy``
    output on the same pair."""
    fig, (ax_p, ax_f) = plt.subplots(1, 2, figsize=(11, 4.2))
    ref_du = _np([r["du"] for r in reference], np.float64).reshape(-1, 2)
    cat_du = _np([e.du_mean for e in catalog], np.float64).reshape(-1, 2)
    ax_p.scatter(ref_du[:, 0], ref_du[:, 1], marker="+", s=70, color="k",
                 label="reference")
    ax_p.scatter(cat_du[:, 0], cat_du[:, 1], marker="o", s=22,
                 facecolors="none", edgecolors="tab:blue", label="catalog")
    for i, j, _ in report["matches"]:
        ax_p.plot([cat_du[i, 0], ref_du[j, 0]], [cat_du[i, 1], ref_du[j, 1]],
                  color="tab:blue", lw=0.8, alpha=0.7)
    for i in report["spurious"]:
        ax_p.scatter(*cat_du[i], marker="x", s=50, color="tab:red")
    for j in report["missed"]:
        ax_p.scatter(*ref_du[j], marker="s", s=60, facecolors="none",
                     edgecolors="tab:orange")
    ax_p.set_xlabel("east offset (arcsec)")
    ax_p.set_ylabel("north offset (arcsec)")
    comp = report["completeness"]
    pur = report["purity"]
    ax_p.set_title("positions — completeness "
                   f"{comp:.2f}, purity {pur:.2f}" if comp is not None
                   else "positions")
    ax_p.legend(fontsize=8)

    xs, ys, es = [], [], []
    for i, j, _ in report["matches"]:
        f_e = _np(catalog[i].flux_mean, np.float64)
        f_s = _np(catalog[i].flux_std, np.float64)
        f_r = _np(reference[j]["flux"], np.float64)
        n_b = min(f_e.shape[0], f_r.shape[0])
        for b in range(n_b):
            if f_r[b] > 0:
                xs.append(f_r[b])
                ys.append(f_e[b] / f_r[b])
                es.append(f_s[b] / f_r[b] if b < f_s.shape[0] else 0.0)
    if xs:
        ax_f.errorbar(xs, ys, yerr=es, fmt="o", ms=4, capsize=2,
                      color="tab:blue")
    ax_f.axhline(1.0, color="k", lw=1)
    ax_f.set_xscale("log")
    ax_f.set_xlabel("reference flux (nmgy)")
    ax_f.set_ylabel("inferred / reference")
    ax_f.set_title("photometry" + (
        f" — rel scatter {report['flux_rel_scatter']:.3f}"
        if report.get("flux_rel_scatter") is not None else ""))
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig
