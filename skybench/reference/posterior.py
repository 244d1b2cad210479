"""The dense joint log posterior of a crowded field, in plain PyTorch: every
component of every source over every pixel (no tiles, no truncation),
the centered Poisson likelihood (each pixel term relative to the saturated
model) and the priors with the log-Jacobians of the unconstrained state.

The state packs each source in scene order: a star [du_e, du_n, log flux
per band], a galaxy the same and [logit theta_dev, log sigma, logit ab,
phi] (du in arcsec from the reference point).  The priors are the
program's defaults, frozen: log flux in the reference slot min(2, nb - 1)
~ N(3, 3), colors ~ N(0, 1.5), a flat position box of half-width 60
arcsec with a unit Gaussian roll-off, theta_dev and ab ~ Beta(1, 1), log
sigma ~ N(0.3, 1), phi flat over pi.

``prep_dtype`` is the precision of the state, the components and the
offsets; ``calc_dtype`` that of the per-term densities, lambda, the
Poisson terms and their sums.  The reference runs both in float64; the
control puts float32 and bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from skybench.reference.support import AMPS, VARS
from skybench.reference.tables import EXP_AMPS

_LOG_SQRT_2PI = 0.9189385332046727
LAMBDA_MIN = 1e-10
N_EXP = len(EXP_AMPS)


def _normal_logpdf(x, mean, std):
    z = (x - mean) / std
    return -0.5 * z * z - math.log(std) - _LOG_SQRT_2PI


def _sig_ljd(x):
    """log d sigmoid / dx."""
    return -x - 2.0 * F.softplus(-x)


class DensePosterior:
    """log p(x) [n] of states x [n, D] for one :class:`Field`."""

    def __init__(self, field, device, prep_dtype=torch.float64, calc_dtype=torch.float64,
                 budget_bytes: int = 1 << 30):
        self.f = field
        self.device = torch.device(device)
        self.prep, self.calc = prep_dtype, calc_dtype
        self.budget = budget_bytes
        kw = dict(dtype=prep_dtype, device=self.device)
        h, w = field.shape
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        self.px = torch.as_tensor(xx.reshape(-1), **kw)
        self.py = torch.as_tensor(yy.reshape(-1), **kw)
        ckw = dict(dtype=calc_dtype, device=self.device)
        self.counts = torch.as_tensor(field.counts.reshape(field.n_bands, -1), **ckw)
        self.mask = torch.as_tensor(field.mask.reshape(field.n_bands, -1), **ckw)
        self.log_xt = torch.log(torch.clamp(self.counts, min=LAMBDA_MIN))
        self.amps = torch.as_tensor(AMPS, **kw)
        self.vars = torch.as_tensor(VARS, **kw)
        self.jac = torch.as_tensor(field.jac, **kw)
        self.p0 = torch.as_tensor(field.p0, **kw)
        self.psf_w = torch.as_tensor(field.psf_w, **kw)
        self.psf_var = torch.as_tensor(field.psf_var, **kw)
        n_comp = sum(self.psf_w.shape[1] * (1 if k == "star" else len(AMPS))
                     for k in field.kinds)
        self.chunk = max(1, budget_bytes // (n_comp * self.px.numel() * 8))

    # -- components -------------------------------------------------------

    def _pixel(self, du):
        j = self.jac
        return (self.p0[0] + j[0, 0] * du[:, 0] + j[0, 1] * du[:, 1],
                self.p0[1] + j[1, 0] * du[:, 0] + j[1, 1] * du[:, 1])

    def _components(self, x, band):
        """(amp, mx, my, cxx, cxy, cyy), each [n, C], of every source in
        flux slot ``band``."""
        nb, k = self.f.n_bands, self.psf_w.shape[1]
        pw, pv = self.psf_w[band], self.psf_var[band]
        parts, off = [], 0
        for kind, width in zip(self.f.kinds, self.f.block_widths()):
            v = x[:, off:off + width]
            off += width
            mx, my = self._pixel(v[:, :2])
            flux = torch.exp(v[:, 2 + band])
            n = v.shape[0]
            if kind == "star":
                amp = flux[:, None] * pw[None, :]
                zero = torch.zeros(n, k, dtype=x.dtype, device=x.device)
                parts.append((amp, mx[:, None].expand(n, k), my[:, None].expand(n, k),
                               pv[None, :].expand(n, k), zero, pv[None, :].expand(n, k)))
                continue
            theta = torch.sigmoid(v[:, 2 + nb])
            sigma = torch.exp(v[:, 3 + nb])
            ab = torch.sigmoid(v[:, 4 + nb])
            phi = v[:, 5 + nb]
            c, s = torch.cos(phi), torch.sin(phi)
            maj, mnr = sigma ** 2, (ab * sigma) ** 2
            wxx, wyy, wxy = c * c * maj + s * s * mnr, s * s * maj + c * c * mnr, c * s * (maj - mnr)
            j = self.jac
            # J W J^T, written out
            r0x, r0y = j[0, 0] * wxx + j[0, 1] * wxy, j[0, 0] * wxy + j[0, 1] * wyy
            r1x, r1y = j[1, 0] * wxx + j[1, 1] * wxy, j[1, 0] * wxy + j[1, 1] * wyy
            pxx = r0x * j[0, 0] + r0y * j[0, 1]
            pxy = r0x * j[1, 0] + r0y * j[1, 1]
            pyy = r1x * j[1, 0] + r1y * j[1, 1]
            mix = torch.cat([(1.0 - theta)[:, None] * self.amps[None, :N_EXP],
                             theta[:, None] * self.amps[None, N_EXP:]], dim=1)   # [n, 16]
            amp = (flux[:, None, None] * mix[:, :, None] * pw[None, None, :]).reshape(n, -1)
            var = self.vars[None, :, None]
            cxx = (var * pxx[:, None, None] + pv[None, None, :]).reshape(n, -1)
            cyy = (var * pyy[:, None, None] + pv[None, None, :]).reshape(n, -1)
            cxy = (var * pxy[:, None, None]).expand(n, len(AMPS), k).reshape(n, -1)
            m = amp.shape[1]
            parts.append((amp, mx[:, None].expand(n, m), my[:, None].expand(n, m), cxx, cxy, cyy))
        return tuple(torch.cat(p, dim=1) for p in zip(*parts))

    def loglik(self, x):
        out = 0.0
        for band in range(self.f.n_bands):
            amp, mx, my, cxx, cxy, cyy = self._components(x, band)
            det = cxx * cyy - cxy * cxy
            ia, ib, ic = cyy / det, -cxy / det, cxx / det
            norm = float(self.f.iota[band]) * amp / (2.0 * math.pi * torch.sqrt(det))
            dx = (self.px[None, None, :] - mx[..., None]).to(self.calc)
            dy = (self.py[None, None, :] - my[..., None]).to(self.calc)
            cast = [t.to(self.calc)[..., None] for t in (ia, ib, ic, norm)]
            quad = cast[0] * dx * dx + 2.0 * cast[1] * dx * dy + cast[2] * dy * dy
            lam = float(self.f.sky[band]) + torch.sum(cast[3] * torch.exp(-0.5 * quad), dim=1)
            lam = torch.clamp(lam, min=LAMBDA_MIN)
            cnt = self.counts[band]
            term = cnt * (torch.log(lam) - self.log_xt[band]) + (cnt - lam)
            out = out + torch.sum(term * self.mask[band], dim=-1)
        return out

    def logprior(self, x):
        nb = self.f.n_bands
        ref = min(2, nb - 1)
        lp, off = 0.0, 0
        for kind, width in zip(self.f.kinds, self.f.block_widths()):
            v = x[:, off:off + width]
            off += width
            lf = v[:, 2:2 + nb]
            lp = lp + _normal_logpdf(lf[:, ref], 3.0, 3.0)
            if nb > 1:
                lp = lp + torch.sum(_normal_logpdf(lf[:, :-1] - lf[:, 1:], 0.0, 1.5), dim=-1)
            lp = lp - torch.sum(lf, dim=-1)
            excess = torch.clamp(torch.abs(v[:, :2]) - 60.0, min=0.0)
            lp = lp - 0.5 * torch.sum(excess ** 2, dim=-1)
            lp = lp + torch.sum(lf, dim=-1)                      # log |det J| of the fluxes
            if kind == "galaxy":
                lt, ls, la = v[:, 2 + nb], v[:, 3 + nb], v[:, 4 + nb]
                theta, ab = torch.sigmoid(lt), torch.sigmoid(la)
                # Beta(1, 1) on theta_dev and ab: zero, kept in its general form
                lp = lp + 0.0 * torch.log(theta) + 0.0 * torch.log1p(-theta)
                lp = lp + 0.0 * torch.log(ab) + 0.0 * torch.log1p(-ab)
                lp = lp + _normal_logpdf(ls, 0.3, 1.0) - ls
                lp = lp - math.log(math.pi)
                lp = lp + _sig_ljd(lt) + ls + _sig_ljd(la)
        return lp

    def logp(self, x):
        """[n, D] -> [n]: the loglik in ``calc_dtype`` and the prior in
        ``prep_dtype``, summed in float64."""
        x = x.to(self.prep)
        return self.loglik(x).double() + self.logprior(x).double()

    def logp_blocks(self, x):
        """log p [N] float64 of states x [N, D], in blocks of chains, with no
        gradient."""
        with torch.no_grad():
            return torch.cat([self.logp(x[c0:c0 + self.chunk])
                              for c0 in range(0, x.shape[0], self.chunk)])

    def value_and_grad(self, z, to_x=None):
        """(log p [N] float64, d log p / dz [N, D] float64) in blocks of
        chains; ``to_x`` maps the state z to x (default: z is x)."""
        vals, grads = [], []
        for c0 in range(0, z.shape[0], self.chunk):
            zc = z[c0:c0 + self.chunk].detach().to(self.prep).requires_grad_(True)
            with torch.enable_grad():
                lp = self.logp(to_x(zc) if to_x is not None else zc)
                (g,) = torch.autograd.grad(lp.sum(), zc)
            vals.append(lp.detach())
            grads.append(g.double())
        return torch.cat(vals), torch.cat(grads)
