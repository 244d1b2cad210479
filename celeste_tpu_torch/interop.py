"""Carry state across from the JAX package as NumPy arrays.

Every function takes NumPy arrays (or array-likes) only, named like the
fields of the JAX package's pytrees, and returns this package's objects on
``device``.  The tests use them to feed one scene and one chain state to
both packages.
"""

from __future__ import annotations

import json
import re

import numpy as np
import torch

from celeste_tpu_torch.inference.chees import ChEESAdaptState, ChEESInfo, ChEESState
from celeste_tpu_torch.inference.ensemble_stretch import StretchState
from celeste_tpu_torch.inference.gibbs import GibbsState
from celeste_tpu_torch.inference.hmc import HMCState
from celeste_tpu_torch.inference.tempering import PTState
from celeste_tpu_torch.inference.type_switch import GaussianPseudoPrior, TypeSwitchState
from celeste_tpu_torch.model.color_prior import ColorGMM
from celeste_tpu_torch.model.params import GalaxyParams, StarParams
from celeste_tpu_torch.model.stamp import Stamp
from celeste_tpu_torch.mog import MoG2D
from celeste_tpu_torch.quasar.basis import QuasarBasis
from celeste_tpu_torch.quasar.filters import FilterBank
from celeste_tpu_torch.quasar.photometry import BandMatrixGrid
from celeste_tpu_torch.utils import checkpoint


def _t(x, device):
    # np.array copies, so read-only buffers (a JAX array's) are never shared
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def stamp_from_numpy(counts, sky, iota, mask, psf_w, psf_mu, psf_cov, wcs_A, wcs_p0,
                     band, device="cpu") -> Stamp:
    """A ``Stamp`` from the JAX ``Stamp`` fields (its PSF given as w, mu, cov)."""
    return Stamp(counts=_t(counts, device), sky=_t(sky, device), iota=_t(iota, device),
                 mask=_t(mask, device),
                 psf=MoG2D(_t(psf_w, device), _t(psf_mu, device), _t(psf_cov, device)),
                 wcs_A=_t(wcs_A, device), wcs_p0=_t(wcs_p0, device), band=int(band))


def star_params_from_numpy(u, flux, device="cpu") -> StarParams:
    return StarParams(u=_t(u, device), flux=_t(flux, device))


def galaxy_params_from_numpy(u, flux, theta_dev, sigma, ab, phi, device="cpu") -> GalaxyParams:
    return GalaxyParams(u=_t(u, device), flux=_t(flux, device),
                        theta_dev=_t(theta_dev, device), sigma=_t(sigma, device),
                        ab=_t(ab, device), phi=_t(phi, device))


def color_gmm_from_fields(weights, means, inv_chols) -> ColorGMM:
    """A ``ColorGMM`` from the JAX one's fields (weights [K], means [K][C],
    inv_chols [K][C][C]), as nested float tuples."""
    return ColorGMM(weights=tuple(float(v) for v in np.asarray(weights, np.float64)),
                    means=tuple(map(tuple, np.asarray(means, np.float64).tolist())),
                    inv_chols=tuple(tuple(map(tuple, m))
                                    for m in np.asarray(inv_chols, np.float64).tolist()))


def hmc_warm_state_from_numpy(x, logp, grad, step_size, inv_mass, device="cpu"):
    """An HMC warm state of B chains: (HMCState with x [B, D], logp [B],
    grad [B, D]; step_size; inv_mass), as a per-chain warmup leaves them."""
    state = HMCState(x=_t(x, device), logp=_t(logp, device), grad=_t(grad, device))
    return state, _t(step_size, device), _t(inv_mass, device)


def chees_state_from_numpy(xs, logps, grads, device="cpu") -> ChEESState:
    """A ChEES ensemble state: xs [B, D], logps [B], grads [B, D]."""
    return ChEESState(xs=_t(xs, device), logps=_t(logps, device), grads=_t(grads, device))


def pseudo_prior_from_numpy(mean, chol, logdet_cov, device="cpu") -> GaussianPseudoPrior:
    """A batch of Gaussian pseudo-priors from JAX ``GaussianPseudoPrior``
    fields, one per row: mean [M, D], chol [M, D, D], logdet_cov [M] (one
    JAX pseudo-prior, [D], [D, D] and a scalar, becomes M = 1)."""
    mean = np.asarray(mean, np.float32)
    d = mean.shape[-1]
    return GaussianPseudoPrior(mean=_t(mean.reshape(-1, d), device),
                               chol=_t(np.reshape(chol, (-1, d, d)), device),
                               logdet_cov=_t(np.reshape(logdet_cov, (-1,)), device))


def type_switch_state_from_numpy(a, star_x, star_logp, star_grad, gal_x, gal_logp, gal_grad,
                                 device="cpu") -> TypeSwitchState:
    """A Carlin-Chib state of B rows: a [B] (0 star, 1 galaxy) and each
    block's HMC state (x [B, D], logp [B], grad [B, D])."""
    return TypeSwitchState(
        a=torch.as_tensor(np.array(a, np.int32), device=device),
        star=HMCState(x=_t(star_x, device), logp=_t(star_logp, device),
                      grad=_t(star_grad, device)),
        gal=HMCState(x=_t(gal_x, device), logp=_t(gal_logp, device), grad=_t(gal_grad, device)))


def gibbs_state_from_numpy(x, logp, device="cpu") -> GibbsState:
    """A block-Gibbs state of B chains: x [B, D_total], logp [B] (one JAX
    state, [D_total] and a scalar, becomes B = 1)."""
    x = np.asarray(x, np.float32)
    return GibbsState(x=_t(x.reshape(-1, x.shape[-1]), device),
                      logp=_t(np.reshape(logp, (-1,)), device))


def stretch_state_from_numpy(xs, logps, device="cpu") -> StretchState:
    """A stretch-move ensemble: xs [K, D], logps [K]."""
    return StretchState(xs=_t(xs, device), logps=_t(logps, device))


def quasar_basis_from_numpy(lam_rest, b, device="cpu") -> QuasarBasis:
    """A ``QuasarBasis`` from the JAX one's fields: lam_rest [L], b [K, L]."""
    return QuasarBasis(lam_rest=_t(lam_rest, device), b=_t(b, device))


def filterbank_from_numpy(lam, resp, dlam, names, device="cpu") -> FilterBank:
    """A ``FilterBank`` from the JAX one's fields: lam, resp, dlam [n_bands,
    n_pts] and the band names."""
    return FilterBank(lam=_t(lam, device), resp=_t(resp, device), dlam=_t(dlam, device),
                      names=tuple(names))


def band_matrix_grid_from_numpy(table, z_max, n_basis, device="cpu") -> BandMatrixGrid:
    """A ``BandMatrixGrid`` from the JAX one's fields: table [n_z, n_bands, K]."""
    return BandMatrixGrid(table=_t(table, device), z_max=float(z_max), n_basis=int(n_basis))


def pt_state_from_numpy(xs, logps, even_phase, device="cpu") -> PTState:
    """A tempering state: xs [..., T, D], untempered logps [..., T] and the
    swap parity of the next step."""
    return PTState(xs=_t(xs, device), logps=_t(logps, device), even_phase=bool(even_phase))


def load_jax_checkpoint(path, like):
    """Read a checkpoint that the JAX package's ``save_checkpoint`` wrote
    into the structure of ``like`` (this package's state of the same
    sampler, say an ``MHState``).  JAX orders its leaves as this package's
    checkpoints do (NamedTuple fields in order, dict keys sorted); its
    ``__meta__`` records a ``treedef`` string instead of this package's
    structure record, so the leaf count, every NamedTuple name of ``like``
    and every leaf's shape and dtype are checked against it.  Returns
    (state, step, extra), tensors on the devices of ``like``'s."""
    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(str(f["__meta__"]))
        flat_like, structure = checkpoint.flatten(like)
        if meta.get("n_leaves") != len(flat_like):
            raise ValueError(f"{path} has {meta.get('n_leaves')} leaves, the target "
                             f"structure has {len(flat_like)}")
        treedef = meta.get("treedef", "")
        for name in re.findall(r"(\w+)\(", structure):
            if f"namedtuple[{name}]" not in treedef:
                raise ValueError(f"{path}'s treedef has no {name}: {treedef}")
        leaves = [np.asarray(f[f"leaf_{i}"]) for i in range(len(flat_like))]
    checkpoint.check_leaves(leaves, flat_like)
    return checkpoint.unflatten(like, leaves), meta.get("step"), meta.get("extra", {})


# the namedtuples in the JAX package's config-5 artifacts: this package's
# class and the fields in pytree order
_NAMEDTUPLES = {"HMCState": (HMCState, ("x", "logp", "grad")),
                "ChEESState": (ChEESState, ("xs", "logps", "grads"))}
# the top-level keys of the two kinds of artifact: the shared preparation
# flow's output and the ChEES arm's adapted ensemble
_PREP_KEYS = {"cov_hat", "inv_mass", "m_hat", "states_x", "states_z", "step_size", "step_z"}
_CHEES_KEYS = {"eps", "st", "traj"}


def _leaf_order(treedef: str):
    """[(key, namedtuple name or None)] of a checkpoint's flat dict of
    arrays and namedtuples of arrays, in leaf order, from the ``treedef``
    string its ``__meta__`` records."""
    out = []
    for m in re.finditer(r"'(\w+)': (?:\*|CustomNode\(namedtuple\[(\w+)\], \[([*, ]*)\]\))",
                         treedef):
        key, name, stars = m.groups()
        if name is not None and (name not in _NAMEDTUPLES
                                 or stars.count("*") != len(_NAMEDTUPLES[name][1])):
            raise ValueError(f"unknown namedtuple {name}[{stars}] in {treedef}")
        out.append((key, name))
    return out


def load_config5_prep(path, device="cpu"):
    """Load a config-5 warm-start artifact of the JAX package: plain arrays
    ``leaf_0..leaf_N`` whose pytree order the file's own ``__meta__``
    records (its keys sorted, a namedtuple's fields in order).

    Two kinds (``celeste_tpu/bench/artifacts/``): the preparation flow's
    output (``config5_prep.npz``, ``config5_multiband_prep.npz``) gives
    ``m_hat`` [D] and ``cov_hat`` [D, D] (the whitening moments),
    ``inv_mass`` [D], ``states_x`` and ``states_z`` (HMCStates of the warmed
    x-space and z-space ensembles) and ``step_size`` and ``step_z``; the
    ChEES arm's adaptation (``config5_multiband_chees_prep.npz``) gives
    ``st`` (a ChEESState of z-space chains), ``eps`` and ``traj``.  Scalars
    come back as floats, arrays as tensors on ``device``; ``meta`` is the
    artifact's own metadata.  The saved ``logp`` / ``logps`` fields are
    whatever the code of the day computed; compare them with a live
    evaluation before trusting them.
    """
    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(str(f["__meta__"]))
        order = _leaf_order(meta.get("treedef", ""))
        keys = {k for k, _ in order}
        n = sum(len(_NAMEDTUPLES[name][1]) if name else 1 for _, name in order)
        if keys not in (_PREP_KEYS, _CHEES_KEYS) or meta.get("n_leaves") != n:
            raise ValueError(f"{path} is not a config-5 warm-start artifact: {meta}")
        leaves = iter(np.asarray(f[f"leaf_{i}"]) for i in range(n))
        out = {"meta": meta}
        for key, name in order:
            if name is None:
                a = next(leaves)
                out[key] = float(a) if a.ndim == 0 else _t(a, device)
            else:
                cls, fields = _NAMEDTUPLES[name]
                out[key] = cls(**{fld: _t(next(leaves), device) for fld in fields})
    return out


def field_checkpoint_from_numpy(phase: str, leaves, device="cpu"):
    """The field group sampler's carry at ``phase`` (``field._SegCkpt.ORDER``)
    from the leaves of a JAX field checkpoint, its ``leaf_0..leaf_N`` arrays
    in order.  JAX holds the chains [G, B, ...]; the port stacks the groups
    set-major, [G B, ...].  The per-group adaptation scalars and (eps, T)
    stay [G] float32 on the host, as the port keeps them; the rest goes to
    ``device``.  The result is what ``field._SegCkpt.load`` returns for the
    same phase, so a JAX-made checkpoint can be written in the port's format
    (``utils.checkpoint.save_checkpoint`` with the JAX file's step and
    ``extra``) and resumed by the port."""
    it = iter(leaves)

    def dev():
        return torch.as_tensor(np.array(next(it)), device=device)

    def rows():
        a = np.array(next(it))
        return torch.as_tensor(a.reshape((-1,) + a.shape[2:]), device=device)

    def host():
        return torch.as_tensor(np.array(next(it), np.float32))

    def state():
        return ChEESState(xs=rows(), logps=rows(), grads=rows())

    def adapt():
        return ChEESAdaptState(*(host() for _ in range(8)))

    if phase == "raw_warmup":
        return state(), adapt()
    if phase == "probe":
        return state(), host(), host(), rows()
    if phase == "z_warmup":
        return dev(), dev(), (state(), adapt())
    if phase == "run":
        return (state(), host(), host(), dev(), dev(), rows(),
                ChEESInfo(*(dev() for _ in range(5))))
    raise ValueError(f"unknown field checkpoint phase {phase!r}")
