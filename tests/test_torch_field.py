"""The port's field catalog pipeline (``celeste_tpu_torch/field.py``) on the
CPU: the counterparts of tests/test_field.py's fast lane (fit groups, the
checkpoint gate, the config checks, detection and classification, blends,
the ingested frame) held against the JAX package on the same frames, and
the carries across from JAX (a JAX ``FieldConfig`` as a plain dict,
``interop.field_checkpoint_from_numpy``) and the experiment config's
defaults.

The JAX package's field computes its likelihoods in plain jnp; the port's
run through the pixel-set mode of K1 and K7, here their plain versions.
The MAP scans must give the same candidates, kinds and groups as JAX's,
with MAP positions within 0.05 arcsec (tests/test_field.py's own gate on
the truth is 0.5 arcsec).  The sampled stages are in
tests/test_torch_field_sampling.py; the slow tests of tests/test_field.py
run uncut on the card (tests/test_torch_kernels_cuda.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from celeste_tpu import experiments as jex
from celeste_tpu import field as jfield
from celeste_tpu.data.synthetic import galaxy_source as j_galaxy_source
from celeste_tpu.data.synthetic import make_synthetic_stamp as j_make_synthetic_stamp
from celeste_tpu.data.synthetic import star_source as j_star_source
from celeste_tpu.model.priors import FluxPrior as JFluxPrior
from celeste_tpu.model.priors import SourcePriors as JSourcePriors

from celeste_tpu_torch import experiments as tex
from celeste_tpu_torch import interop
from celeste_tpu_torch.data.synthetic import galaxy_source, make_synthetic_stamp, star_source
from celeste_tpu_torch.field import FieldConfig, _SegCkpt, run_field_pipeline, union_groups
from celeste_tpu_torch.model.priors import FluxPrior, SourcePriors
from celeste_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

PRIORS = SourcePriors(flux=FluxPrior(log_ref_mean=3.2, log_ref_std=2.0))
J_PRIORS = JSourcePriors(flux=JFluxPrior(log_ref_mean=3.2, log_ref_std=2.0))
ASU = 1.0 / 3600.0
COSD = np.cos(np.deg2rad(10.0))
MAP_TOL_ARCSEC = 0.05


def _mixed_sources(star, galaxy):
    """tests/test_field.py's 96x96 frame: 3 isolated stars + a star/galaxy
    blend 2.4'' apart."""
    return [
        star(u=(30.0 - 14 * ASU / COSD, 10.0 - 13 * ASU), flux_r=60.0),
        star(u=(30.0 + 15 * ASU / COSD, 10.0 - 11 * ASU), flux_r=30.0),
        star(u=(30.0 - 12 * ASU / COSD, 10.0 + 14 * ASU), flux_r=45.0),
        star(u=(30.0 + 10 * ASU / COSD, 10.0 + 12 * ASU), flux_r=40.0),
        galaxy(u=(30.0 + 10 * ASU / COSD, 10.0 + (12 + 2.4) * ASU), flux_r=80.0, sigma=1.6,
               ab=0.7),
    ]


def test_union_groups():
    pos = np.array([[0.0, 0.0], [5.0, 0.0], [40.0, 40.0], [40.0, 44.0], [9.0, 0.0]])
    labels = union_groups(pos, link_radius_px=6.0)
    # 0-1-4 chain through transitivity; 2-3 together
    assert labels.tolist() == [0, 0, 1, 1, 0]
    assert union_groups(pos, link_radius_px=1.0).tolist() == [0, 1, 2, 3, 4]


def _brute_labels(pos, r):
    """All-pairs reference partition, canonical first-member labeling."""
    n = pos.shape[0]
    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    adj = d2 <= r * r
    labels = -np.ones(n, np.int32)
    nxt = 0
    for i in range(n):
        if labels[i] >= 0:
            continue
        stack, labels[i] = [i], nxt
        while stack:
            j = stack.pop()
            for m in np.nonzero(adj[j] & (labels < 0))[0]:
                labels[m] = nxt
                stack.append(int(m))
        nxt += 1
    return labels


def test_union_groups_grid_hash_matches_brute_force_and_jax():
    """The grid hash gives the all-pairs partition and labeling, and JAX's
    labels, on a dense 2k-candidate frame across radii from isolated to
    one blob."""
    rng = np.random.default_rng(7)
    centers = rng.uniform(0, 2048, size=(40, 2))
    pos = np.concatenate([
        centers[rng.integers(0, 40, 1500)] + rng.normal(0, 6.0, (1500, 2)),
        rng.uniform(0, 2048, size=(490, 2)),
        np.repeat(rng.uniform(0, 2048, size=(5, 2)), 2, axis=0),
    ])
    for r in (0.0, 3.0, 9.0, 40.0):
        got = union_groups(pos, link_radius_px=r)
        np.testing.assert_array_equal(got, _brute_labels(pos, r), err_msg=f"r={r}")
        np.testing.assert_array_equal(got, jfield.union_groups(pos, link_radius_px=r))


def test_segckpt_rejects_foreign_and_reconfigured_files(tmp_path):
    """The checkpoint gate treats as foreign: files missing the fingerprint
    or phase (another producer sharing the path), scalar fingerprints, and
    same-shape runs whose stream-affecting knobs differ."""
    fp = {"x0_sum": 1.5, "n_steps": 20, "priors": "SourcePriors(...)"}
    p = str(tmp_path / "ck.npz")
    carry = {"a": torch.zeros(3)}
    ck = _SegCkpt(p, fp)
    ck.save("probe", carry, 4)
    ck2 = _SegCkpt(p, dict(fp))              # same run resumes
    assert ck2.at("probe") and ck2.off == 4 and ck2.past("raw_warmup")
    state, off = ck2.load({"a": torch.ones(3)})
    assert off == 4 and torch.equal(state["a"], torch.zeros(3))
    with pytest.raises(ValueError, match="different run"):
        _SegCkpt(p, dict(fp, n_steps=30))    # knob changed
    with pytest.raises(ValueError, match="different run"):
        _SegCkpt(p, dict(fp, extra_knob=1))  # key sets differ
    save_checkpoint(p, carry, step=0, extra={})   # foreign producer
    with pytest.raises(ValueError, match="different run"):
        _SegCkpt(p, fp)
    save_checkpoint(p, carry, step=0, extra={"fp": 1.5, "phase": "probe"})  # scalar fp
    with pytest.raises(ValueError, match="different run"):
        _SegCkpt(p, fp)


def test_field_config_rejects_bad_segments():
    """sample_segment < 1 and warmup_window < 1 fail before any detection
    work, and a checkpoint path without segments has no boundary to save
    at."""
    scene = make_synthetic_stamp([star_source(u=(30.0, 10.0), flux_r=40.0)], shape=(32, 32),
                                 bands=(2,), seed=1, device="cpu")
    for bad, msg in ((dict(sample_segment=0), "must be >= 1"),
                     (dict(sample_segment=-3), "must be >= 1"),
                     (dict(sample_segment=8, warmup_window=0), "must be >= 1"),
                     (dict(checkpoint_path="x.npz"), "requires cfg.sample_segment")):
        with pytest.raises(ValueError, match=msg):
            run_field_pipeline(scene.stamps[0], band=0, n_bands=1, cfg=FieldConfig(**bad),
                               priors=PRIORS)


@pytest.fixture(scope="module")
def map_only():
    """The port's and JAX's MAP scans of the mixed frame (JAX's
    ``map_only_result``: FieldConfig(sample=False, seed=2), map_steps 200)."""
    tscene = make_synthetic_stamp(_mixed_sources(star_source, galaxy_source), shape=(96, 96),
                                  bands=(2,), seed=11, device="cpu")
    srcs = _mixed_sources(j_star_source, j_galaxy_source)
    jscene = j_make_synthetic_stamp(srcs, shape=(96, 96), bands=(2,), seed=11)
    port = run_field_pipeline(tscene.stamps[0], band=0, n_bands=1,
                              cfg=FieldConfig(sample=False, seed=2), priors=PRIORS)
    ref = jfield.run_field_pipeline(jscene.stamps[0], band=0, n_bands=1,
                                    cfg=jfield.FieldConfig(sample=False, seed=2),
                                    priors=J_PRIORS)
    return tscene, srcs, port, ref


def test_field_detects_and_classifies(map_only):
    scene, srcs, (catalog, art), _ = map_only
    assert art["n_sources"] == 5
    kinds = sorted(e.kind for e in catalog)
    assert kinds == ["galaxy", "star", "star", "star", "star"], [(e.kind, e.p_star)
                                                                 for e in catalog]
    # CLEAN-ripple duplicates must not survive: every catalog entry matches
    # a distinct truth source within 0.5''
    truth = np.array([scene.wcs.equa2duas(s["u"]) for s in srcs])
    est = np.array([e.du_mean for e in catalog])
    d = np.hypot(truth[:, None, 0] - est[None, :, 0], truth[:, None, 1] - est[None, :, 1])
    match = np.argmin(d, axis=1)
    assert len(set(match.tolist())) == 5
    assert float(d[np.arange(5), match].max()) < 0.5


def test_field_groups_blend_jointly(map_only):
    _, _, (catalog, art), _ = map_only
    # the blended pair shares a fit group; the isolated stars don't
    assert art["n_groups"] == 4 and art["s_max"] == 2
    groups = [e.extras["group"] for e in catalog]
    pair = [g for g in set(groups) if groups.count(g) == 2]
    assert len(pair) == 1
    assert sorted(e.kind for e in catalog if e.extras["group"] == pair[0]) == ["galaxy", "star"]


def test_field_map_scan_matches_jax(map_only):
    """The same catalog as JAX's on the same frame: sources, kinds, groups
    (sizes and membership) and MAP positions within MAP_TOL_ARCSEC, fluxes
    within 1%."""
    _, _, (cat, art), (jcat, jart) = map_only
    assert len(cat) == len(jcat) and art["n_groups"] == jart["n_groups"]
    assert art["s_max"] == jart["s_max"]
    assert sorted(map(len, art["groups"])) == sorted(map(len, jart["groups"]))
    est = np.array([e.du_mean for e in cat])
    ref = np.array([np.asarray(e.du_mean) for e in jcat])
    d = np.hypot(est[:, None, 0] - ref[None, :, 0], est[:, None, 1] - ref[None, :, 1])
    match = np.argmin(d, axis=1)
    assert len(set(match.tolist())) == len(cat)
    assert float(d[np.arange(len(cat)), match].max()) < MAP_TOL_ARCSEC, d
    for i, j in enumerate(match):
        assert cat[i].kind == jcat[j].kind
        np.testing.assert_allclose(cat[i].flux_mean, np.asarray(jcat[j].flux_mean), rtol=0.01)
    # group membership: entries sharing a group in one share it in the other
    g, jg = [e.extras["group"] for e in cat], [e.extras["group"] for e in jcat]
    for a in range(len(cat)):
        for b in range(len(cat)):
            assert (g[a] == g[b]) == (jg[match[a]] == jg[match[b]])


def test_field_on_ingested_frame(tmp_path):
    """Real FITS bytes -> the port's ``frame_to_stamp`` -> the port's field
    MAP scan (tests/test_field.py:241): a Poisson-noised SDSS-like frame
    (calibrated nmgy image, calib row, gridded sky) with 4 known stars comes
    back as a 4-star catalog with sub-0.5'' positions and ~10% fluxes."""
    from celeste_tpu_torch.data.ingest.fits_lite import (write_fits, write_fits_image,
                                                         write_fits_table)
    from celeste_tpu_torch.data.ingest.sdss import frame_to_stamp
    from celeste_tpu_torch.mog import MoG2D

    rng = np.random.default_rng(3)
    h, w, gain = 120, 160, 4.6
    var_px = 2.2                      # injected single-Gaussian PSF (px^2)
    stars = [(40.0, 30.0, 30000.0), (100.0, 40.0, 18000.0),
             (50.0, 90.0, 45000.0), (90.0, 80.0, 24000.0)]  # (px, py, nelec)
    yy, xx = np.mgrid[0:h, 0:w]
    sky_nelec = 150.0 + 20.0 * np.linspace(0, 1, h)[:, None] * np.ones((1, w))
    nelec = sky_nelec.copy()
    for px, py, f in stars:
        nelec += f / (2 * np.pi * var_px) * np.exp(-0.5 * ((xx - px) ** 2 + (yy - py) ** 2)
                                                   / var_px)
    nelec_obs = rng.poisson(nelec).astype(np.float64)
    calib = np.full(w, 0.005, np.float64) * (1 + 0.01 * np.linspace(0, 1, w))
    dn, sky_dn = nelec_obs / gain, sky_nelec / gain
    img = (dn - sky_dn) * calib[None, :]
    gy, gx = 6, 8
    ys_g, xs_g = np.linspace(0, h - 1, gy), np.linspace(0, w - 1, gx)
    allsky = sky_dn[np.ix_(ys_g.astype(int), xs_g.astype(int))]
    xinterp = np.interp(np.arange(w), xs_g, np.arange(gx))
    yinterp = np.interp(np.arange(h), ys_g, np.arange(gy))
    wcs_cards = {"CRVAL1": 30.0, "CRVAL2": 10.0, "CRPIX1": w / 2 + 0.5, "CRPIX2": h / 2 + 0.5,
                 "CD1_1": 0.396 / 3600, "CD1_2": 0.0, "CD2_1": 0.0, "CD2_2": 0.396 / 3600}
    path = str(tmp_path / "frame-r-000002-1-0001.fits")
    write_fits(path, [
        write_fits_image(img.astype(np.float32), extra_cards=wcs_cards),
        write_fits_image(calib.astype(np.float32), primary=False),
        write_fits_table({"ALLSKY": allsky.astype(np.float64)}),
        write_fits_table({"XINTERP": xinterp[None, :].astype(np.float64),
                          "YINTERP": yinterp[None, :].astype(np.float64)}),
    ])
    psf = MoG2D(w=torch.ones(1), mu=torch.zeros(1, 2), cov=(var_px * torch.eye(2))[None])
    stamp, meta = frame_to_stamp(path, (30.0, 10.0), size=120, gain=gain, psf=psf,
                                 device="cpu")
    x0, y0 = meta["pixel_origin"]
    iota = float(stamp.iota)

    catalog, art = run_field_pipeline(stamp, band=0, n_bands=1,
                                      cfg=FieldConfig(sample=False, type_switch=False, seed=9),
                                      priors=PRIORS)
    assert art["n_sources"] == 4, [(e.kind, e.du_mean) for e in catalog]
    assert all(e.kind == "star" for e in catalog)
    a = stamp.wcs_A.numpy().astype(np.float64)
    p0 = stamp.wcs_p0.numpy().astype(np.float64)
    a_inv = np.linalg.inv(a)
    truth_du = np.array([a_inv @ (np.array([px - x0, py - y0]) - p0) for px, py, _ in stars])
    truth_flux = np.array([f for _, _, f in stars]) / iota
    est_du = np.array([e.du_mean for e in catalog])
    d = np.hypot(truth_du[:, None, 0] - est_du[None, :, 0], truth_du[:, None, 1] - est_du[None, :, 1])
    match = np.argmin(d, axis=1)
    assert len(set(match.tolist())) == 4
    assert float(d[np.arange(4), match].max()) < 0.5
    est_flux = np.array([float(catalog[m].flux_mean[0]) for m in match])
    np.testing.assert_allclose(est_flux, truth_flux, rtol=0.12)


def test_experiment_config_defaults_match_jax():
    """Every field of the port's ExperimentConfig but ``device`` has JAX's
    default (the sampler's was "mh" in the port, "nuts" in JAX), and the
    two dataclasses have the same fields apart from ``device``; the field
    configs are JAX's."""
    got = {f.name: f.default for f in dataclasses.fields(tex.ExperimentConfig)}
    want = {f.name: f.default for f in dataclasses.fields(jex.ExperimentConfig)}
    assert got.pop("device") == "cuda"
    assert got == want
    for name in ("field", "field_survey"):
        port = dataclasses.asdict(tex.CONFIGS[name])
        port.pop("device")
        assert port == dataclasses.asdict(jex.CONFIGS[name])


def test_field_config_and_checkpoint_from_jax(tmp_path):
    """A JAX FieldConfig feeds the port as a dict, field for field, and a
    JAX field checkpoint of each phase (written by JAX's own ``_SegCkpt``)
    becomes the port's carry: JAX's [G, B, ...] chains the port's set-major
    rows, every value equal; written back in the port's format it resumes
    through the port's ``_SegCkpt``."""
    import jax.numpy as jnp
    from celeste_tpu.inference import chees as jchees

    jcfg = jfield.FieldConfig(n_chains=12, probe_warmup=32, max_leapfrog=24, seed=4)
    assert dataclasses.asdict(FieldConfig(**dataclasses.asdict(jcfg))) == \
        dataclasses.asdict(jcfg)
    assert {f.name for f in dataclasses.fields(FieldConfig)} == \
        {f.name for f in dataclasses.fields(jfield.FieldConfig)}
    rng = np.random.default_rng(0)
    g, b, d, n = 2, 3, 7, 5

    def r(*shape):
        return jnp.asarray(rng.normal(size=shape).astype(np.float32))

    state = jchees.ChEESState(xs=r(g, b, d), logps=r(g, b), grads=r(g, b, d))
    adapt = jchees.ChEESAdaptState(*(r(g) for _ in range(8)))
    info = jchees.ChEESInfo(accept_rate=r(g, n), n_leapfrog=jnp.ones((g, n), jnp.int32),
                            trajectory_length=r(g, n), step_size=r(g, n),
                            divergence_rate=r(g, n))
    carries = {"raw_warmup": (state, adapt), "probe": (state, r(g), r(g), r(g, b, n, d)),
               "z_warmup": (r(g, d), r(g, d, d), (state, adapt)),
               "run": (state, r(g), r(g), r(g, d), r(g, d, d), r(g, b, n, d), info)}
    fp = {"x0_sum": 0.5, "n_steps": n}
    for phase, carry in carries.items():
        path = str(tmp_path / f"{phase}.npz")
        jfield._SegCkpt(path, fp).save(phase, carry, 3)
        with np.load(path) as f:
            leaves = [f[f"leaf_{i}"] for i in range(len(jax.tree_util.tree_leaves(carry)))]
        port = interop.field_checkpoint_from_numpy(phase, leaves)
        flat_j = [np.asarray(a) for a in jax.tree_util.tree_leaves(carry)]
        from celeste_tpu_torch.utils.checkpoint import flatten
        flat_t, _ = flatten(port)
        assert len(flat_t) == len(flat_j)
        for a, w in zip(flat_t, flat_j):
            np.testing.assert_array_equal(a.numpy(), w.reshape(a.shape))
        assert flat_t[0].shape == (g * b, d) if phase != "z_warmup" else True
        ours = str(tmp_path / f"{phase}.port.npz")
        save_checkpoint(ours, port, step=3, extra={"phase": phase, "fp": fp})
        ck = _SegCkpt(ours, fp)
        assert ck.at(phase) and ck.off == 3
        back, _, _ = load_checkpoint(ours, port)
        for a, w in zip(flatten(back)[0], flat_t):
            assert torch.equal(a, w)
