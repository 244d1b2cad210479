"""The JAX package's stamp-pipeline machinery, written out for the port's
tests: the closures of ``celeste_tpu/pipeline.py::run_pipeline`` (the
effective-sky conditional log density, the detection fit, the batched
classification sweep, :150-235) are local to that function, so the tests
rebuild them here from the same JAX functions, line for line, to evaluate
JAX's conditional posteriors and sweeps at the port's inputs."""

from types import SimpleNamespace

import numpy as np

import jax
import jax.numpy as jnp

from celeste_tpu.inference.map_fit import map_fit
from celeste_tpu.inference.model_select import laplace_evidence
from celeste_tpu.kernels.mog_field import (
    _field_planes,
    _loglik_jnp,
    mixed_field_planes,
    stamp_pixel_data,
)
from celeste_tpu.model.params import GalaxyParams, StarParams


def jax_pipeline_machinery(stamps, bands, n_bands, priors, map_steps):
    """(cond_logd(kind) -> logd(x, effs), scene_effs(rects, flags, alive),
    det_fit(x0, counts_list), classify_sweep_batch(rects, flags, alive)) as
    ``run_pipeline`` builds them, for ``classify=True``."""
    ds = 2 + n_bands
    pds = [stamp_pixel_data(st) for st in stamps]

    def lam_from_planes(planes, px, py):
        amp, mx, my, pa, pb, pc = planes
        dx = px[0][None, :] - mx[:, None]
        dy = py[0][None, :] - my[:, None]
        quad = (pa[:, None] * dx * dx + 2.0 * pb[:, None] * dx * dy
                + pc[:, None] * dy * dy)
        return jnp.sum(amp[:, None] * jnp.exp(-0.5 * quad), axis=0)

    def cond_logd(kind):
        def logd(x, effs):
            ll = 0.0
            for pd, st, b, eff in zip(pds, stamps, bands, effs):
                px, py, counts, _, mask = pd
                planes = _field_planes(x, st, b, kind, n_bands)
                planes_b = tuple(p[None] for p in planes)
                ll = ll + _loglik_jnp(*planes_b, px, py, counts, eff[None], mask)[0]
            if kind == "star":
                p = StarParams.from_vector(x, n_bands)
                lp = priors.star_logpdf(p) + StarParams.log_det_jacobian(x, n_bands)
            else:
                p = GalaxyParams.from_vector(x, n_bands)
                lp = priors.galaxy_logpdf(p) + GalaxyParams.log_det_jacobian(x, n_bands)
            return ll + lp
        return logd

    logd_s, logd_g = cond_logd("star"), cond_logd("galaxy")

    @jax.jit
    def det_fit(x0, counts_list):
        def logd(x):
            ll = 0.0
            for pd, st, b, cts in zip(pds, stamps, bands, counts_list):
                px, py, _, sky, mask = pd
                planes = _field_planes(x, st, b, "star", n_bands)
                planes_b = tuple(p[None] for p in planes)
                ll = ll + _loglik_jnp(*planes_b, px, py, cts[None], sky, mask)[0]
            p = StarParams.from_vector(x, n_bands)
            return ll + priors.star_logpdf(p) + StarParams.log_det_jacobian(x, n_bands)

        x_map, _ = map_fit(logd, x0, n_steps=map_steps)
        lams = []
        for pd, st, b in zip(pds, stamps, bands):
            planes = _field_planes(x_map, st, b, "star", n_bands)
            lams.append(lam_from_planes(planes, pd[0], pd[1]))
        return x_map, lams

    def scene_effs(rects, flags, alive):
        effs_per_stamp = []
        for pd, st, b in zip(pds, stamps, bands):
            lam_all = jax.vmap(lambda r, f: lam_from_planes(
                mixed_field_planes(r, st, b, n_bands, f), pd[0], pd[1]))(rects, flags)
            lam_alive = jnp.where(alive[:, None], lam_all, 0.0)
            total = jnp.sum(lam_alive, axis=0)
            effs_per_stamp.append(pd[3][0][None, :] + total[None, :] - lam_alive)
        return effs_per_stamp

    @jax.jit
    def classify_sweep_batch(rects, flags, alive):
        effs_per_stamp = scene_effs(rects, flags, alive)

        def per_cand(rect, *effs):
            xs, _ = map_fit(lambda x: logd_s(x, effs), rect[:ds], n_steps=map_steps)
            lz_s = laplace_evidence(lambda x: logd_s(x, effs), xs)
            xg, _ = map_fit(lambda x: logd_g(x, effs), rect, n_steps=map_steps)
            lz_g = laplace_evidence(lambda x: logd_g(x, effs), xg)
            lz_0 = 0.0
            for pd, eff in zip(pds, effs):
                _, _, counts, _, mask = pd
                lz_0 = lz_0 + jnp.sum((counts[0] * jnp.log(eff) - eff) * mask[0])
            return xs, lz_s, xg, lz_g, lz_0

        return jax.vmap(per_cand)(rects, *effs_per_stamp)

    return SimpleNamespace(cond_logd=cond_logd, scene_effs=scene_effs, det_fit=det_fit,
                           classify_sweep_batch=classify_sweep_batch, pds=pds)


def rects_of(cand, n_bands):
    """The rectangular candidate states of ``run_pipeline`` (``_rect_of``)."""
    ds, dg = 2 + n_bands, 6 + n_bands
    out = np.zeros((len(cand), dg), np.float32)
    for i, c in enumerate(cand):
        if c["kind"] == "star":
            out[i, :ds] = c["x"][:ds]
            out[i, ds:] = [0.0, 0.0, 0.0, 0.5]
        else:
            out[i] = c["x"]
    return out
