"""Quasar rest-frame SED basis (counterpart of ``celeste_tpu/quasar/basis.py``;
the reference's ``quasar_fit_basis`` fits a nonnegative K-spectrum basis to
BOSS spectra by MAP optimization with a softmax reparameterization).

Same model:
  f_rest_i(lam) = m_i * sum_b softmax(omega_i)_b B_b(lam),  B_b >= 0,
optimized with ``torch.optim.Adam`` over {log B, omega_i, log m_i} with a
Gaussian spectro likelihood and a second-difference smoothness prior on
log B.  No BOSS data ships with the repository, so
``synthetic_quasar_spectra`` fabricates quasar spectra (power-law continuum
and broad emission lines at the classic rest-frame wavelengths) for tests;
the shipped basis (``artifacts/default_basis.npz``, a byte copy of the JAX
package's) loads through ``QuasarBasis.default``.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

# classic quasar broad emission lines, rest-frame nm: (center, width, strength)
QUASAR_LINES = [
    (121.6, 1.5, 8.0),    # Ly-alpha
    (154.9, 2.5, 3.0),    # C IV
    (190.9, 3.0, 1.5),    # C III]
    (279.8, 4.0, 1.8),    # Mg II
    (486.1, 5.0, 1.2),    # H-beta
    (500.7, 1.5, 0.8),    # [O III]
    (656.3, 7.0, 2.5),    # H-alpha
]
DEFAULT_BASIS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                             "default_basis.npz")


def _f32(x, device):
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


class QuasarBasis(NamedTuple):
    lam_rest: torch.Tensor   # [L] rest-frame wavelength grid (nm)
    b: torch.Tensor          # [K, L] nonnegative basis spectra

    @property
    def n_basis(self):
        return self.b.shape[0]

    def to(self, device) -> "QuasarBasis":
        return QuasarBasis(lam_rest=self.lam_rest.to(device), b=self.b.to(device))

    @classmethod
    def default(cls, device="cpu"):
        """The shipped basis (fit on synthetic spectra; a BOSS-trained .npz
        drops in via ``load``)."""
        return cls.load(DEFAULT_BASIS, device)

    def save(self, path):
        np.savez(path, lam_rest=self.lam_rest.cpu().numpy(), b=self.b.cpu().numpy())

    @classmethod
    def load(cls, path, device="cpu"):
        with np.load(path) as d:
            return cls(lam_rest=_f32(d["lam_rest"], device), b=_f32(d["b"], device))


def synthetic_template_basis(n_grid: int = 1024, lam_min: float = 80.0,
                             lam_max: float = 1000.0, device="cpu"):
    """Ground-truth templates for synthetic experiments: K=4 components =
    {blue continuum, red continuum, strong-line spectrum, weak-line
    spectrum}, unit-normalized, built in float64 NumPy as the JAX package
    builds them.  Returns a QuasarBasis."""
    lam = np.geomspace(lam_min, lam_max, n_grid)

    def lines(strength_scale, width_scale=1.0):
        out = np.zeros_like(lam)
        for c, w, s in QUASAR_LINES:
            out += s * strength_scale * np.exp(-0.5 * ((lam - c) / (w * width_scale)) ** 2)
        return out

    cont_blue = (lam / 250.0) ** (-1.7)
    cont_red = (lam / 250.0) ** (-0.3)
    tpl = np.stack([
        cont_blue,
        cont_red,
        0.15 * cont_blue + lines(1.0) * cont_blue.mean(),
        0.3 * cont_red + lines(0.25, 1.6) * cont_red.mean(),
    ])
    # Lyman break: suppress flux blueward of Ly-alpha (IGM absorption)
    supp = 1.0 / (1.0 + np.exp(-(lam - 115.0) / 3.0))
    tpl = tpl * supp[None, :]
    tpl = tpl / np.trapezoid(tpl, lam, axis=1)[:, None]
    return QuasarBasis(lam_rest=_f32(lam, device), b=_f32(tpl, device))


def synthetic_quasar_spectra(n_spec: int, basis: QuasarBasis | None = None, seed: int = 0,
                             snr: float = 20.0):
    """Draw synthetic rest-frame spectra from random simplex weights over a
    template basis, with Gaussian noise (NumPy ``default_rng(seed)``, as the
    JAX package draws them).  Returns (spectra [N, L], ivar [N, L], true
    weights [N, K], true scales [N]) as float32 tensors on the basis's
    device."""
    basis = basis or synthetic_template_basis()
    device = basis.b.device
    rng = np.random.default_rng(seed)
    k = basis.n_basis
    w = rng.dirichlet(np.full(k, 0.7), size=n_spec)
    m = np.exp(rng.normal(0.0, 0.5, size=n_spec))
    clean = m[:, None] * (w @ basis.b.cpu().numpy())
    sigma = np.maximum(clean, 1e-12).mean(axis=1, keepdims=True) / snr
    noisy = clean + rng.normal(size=clean.shape) * sigma
    ivar = np.broadcast_to(1.0 / sigma**2, clean.shape)
    return _f32(noisy, device), _f32(ivar, device), _f32(w, device), _f32(m, device)


def fit_basis(spectra, ivar, lam_rest, n_basis: int = 4, n_steps: int = 2000,
              learning_rate: float = 0.02, smoothness: float = 10.0, seed: int = 0):
    """MAP basis fit (the reference's LBFGS objective, run with Adam):

      max over {log B [K,L], omega [N,K], log m [N]} of
        -0.5 sum ivar * (spec - m softmax(omega) exp(log B))^2
        - smoothness * sum (d^2 log B / d index^2)^2

    ``torch.optim.Adam`` with the JAX package's steps and learning rate;
    the start is drawn from a generator seeded with ``seed``.  Returns
    (QuasarBasis, losses [n_steps])."""
    spectra = torch.as_tensor(spectra, dtype=torch.float32)
    ivar = torch.as_tensor(ivar, dtype=torch.float32, device=spectra.device)
    lam_rest = torch.as_tensor(lam_rest, dtype=torch.float32, device=spectra.device)
    n, length = spectra.shape
    gen = torch.Generator(device=spectra.device)
    gen.manual_seed(seed)
    kw = dict(generator=gen, device=spectra.device)
    mean_spec = torch.clamp(torch.mean(spectra, dim=0), min=1e-8)
    log_b = (torch.log(mean_spec)[None, :] + 0.1 * torch.randn((n_basis, length), **kw))
    omega = 0.1 * torch.randn((n, n_basis), **kw)
    log_m = torch.zeros(n, device=spectra.device)
    params = [p.requires_grad_(True) for p in (log_b, omega, log_m)]
    opt = torch.optim.Adam(params, lr=learning_rate)

    def loss_fn():
        b = torch.exp(log_b)                              # [K, L] nonneg
        w = torch.softmax(omega, dim=-1)                  # [N, K] simplex
        # the [N, K] x [K, L] product as a broadcast sum: no TF32 on the card
        model = torch.exp(log_m)[:, None] * torch.sum(w[:, :, None] * b[None], dim=1)
        data_term = 0.5 * torch.sum(ivar * (spectra - model) ** 2)
        d2 = log_b[:, 2:] - 2.0 * log_b[:, 1:-1] + log_b[:, :-2]
        return (data_term + smoothness * torch.sum(d2 * d2)) / n

    losses = []
    for _ in range(n_steps):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        b = torch.exp(log_b)
        # normalize each basis spectrum to unit integral (scale absorbed by m)
        b = b / torch.trapezoid(b, lam_rest, dim=1)[:, None]
    return QuasarBasis(lam_rest=lam_rest, b=b), torch.stack(losses)
