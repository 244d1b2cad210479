"""The comparison that decides ``correct``.

The program's own outputs are held against the dense float64 reference
(:mod:`skybench.reference`), which works the whitened space out again from
the probe's draws, evaluates the untiled posterior and its gradient at the
window's states, and works out the posterior's moments by itself:

- ``logp_gap_nats``: the largest |log p - reference| over every chain's
  final state and the sampled chains' states at each segment's end;
- ``grad_rel_gap``: the largest |grad - reference| / max(|reference|, the
  median chain's |reference|) over the same states (norms over D);
- ``stuck_share``: the share of chains whose state never changed in the
  window;
- ``moment_gap_sd``: over the D parameters, the largest gap between the
  window's draws (every chain and step pooled) and the reference's
  posterior: |mean - reference mean| / reference sd, or |sd / reference sd
  - 1|.  It holds the sampler's transitions to the posterior: a step that
  accepts what it should reject, or moves on a stale momentum, leaves each
  state consistent with its log p and gradient but the draws' spread
  wrong.
"""

from __future__ import annotations

import torch

from skybench.reference.moments import find_mode, importance_moments
from skybench.reference.posterior import DensePosterior
from skybench.reference.whiten import WhiteMap, pooled_moments

NUMBERS = ("logp_gap_nats", "grad_rel_gap", "stuck_share", "moment_gap_sd")


def reference_map(inputs, dtype=torch.float64):
    m, cov = pooled_moments(inputs["probe_draws"], inputs["ridge"])
    wm = WhiteMap(m, cov)
    if dtype != torch.float64:
        wm.m, wm.chol = wm.m.to(dtype), wm.chol.to(dtype)
    return wm


def _states(inputs):
    return list(inputs["segment_states"]) + [inputs["final"]]


def gaps(pairs):
    """(largest log p gap, largest relative gradient gap) over pairs of
    ((log p, grad) judged, (log p, grad) reference)."""
    lp_gap, g_gap = 0.0, 0.0
    for (lp, g), (rlp, rg) in pairs:
        lp_gap = max(lp_gap, float((lp.double() - rlp).abs().max()))
        rn = rg.norm(dim=1)
        denom = torch.clamp(rn, min=float(rn.median()))
        g_gap = max(g_gap, float(((g.double() - rg).norm(dim=1) / denom).max()))
    return lp_gap, g_gap


class Reference:
    """What the reference works out for one run: (log p, grad) at every
    checked state, and, with ``samples`` importance draws made with
    ``gen``, the posterior's mean and sd of each parameter."""

    def __init__(self, field, inputs, device, samples: int = 0, gen=None):
        post, self.wm = DensePosterior(field, device), reference_map(inputs)
        self.values = [post.value_and_grad(z.double(), self.wm.to_x)
                       for z, _, _ in _states(inputs)]
        if samples:
            mode, cov, self.newton_iters = find_mode(post, field.truth)
            self.mean, self.sd, self.is_share = importance_moments(post, mode, cov, samples,
                                                                   gen)

    def draw_moments(self, draws):
        """(mean [D], sd [D]) in x of the program's pooled draws (n, sum of
        z [D], sum of z z^T [D, D]), through the reference's whitening."""
        n, s1, s2 = draws
        mz = s1 / n
        cz = (s2 - n * torch.outer(mz, mz)) / (n - 1)
        chol = self.wm.chol
        return self.wm.to_x(mz[None])[0], torch.sqrt(torch.diagonal(chol @ cz @ chol.T))


def control_values(field, inputs, device):
    """The control: the reference put in the program's place at the
    configuration's float32, its per-term densities, lambda and Poisson sums
    in bfloat16."""
    ref = DensePosterior(field, device, prep_dtype=torch.float32, calc_dtype=torch.bfloat16)
    wm = reference_map(inputs, torch.float32)
    return [ref.value_and_grad(z.float(), wm.to_x) for z, _, _ in _states(inputs)]


def state_readings(inputs, ref_values, judged=None):
    """The numbers of the states: of the program (``judged`` None) or of
    another side's (log p, grad) at the same states."""
    judged = judged if judged is not None else [(lp, g) for _, lp, g in _states(inputs)]
    lp_gap, g_gap = gaps(zip(judged, ref_values))
    stuck = 1.0 - float(inputs["moved"].double().mean())
    return {"logp_gap_nats": lp_gap, "grad_rel_gap": g_gap, "stuck_share": stuck}


def readings(inputs, ref: Reference) -> dict:
    """Every compared number of the program."""
    return dict(state_readings(inputs, ref.values),
                moment_gap_sd=max(moment_gaps(inputs, ref).values()))


def moment_gaps(inputs, ref: Reference) -> dict:
    """The largest gaps over the parameters of the draws' means and sds from
    the reference's, in reference sds."""
    mean, sd = ref.draw_moments(inputs["draws"])
    return {"mean": float(((mean - ref.mean).abs() / ref.sd).max()),
            "sd": float((sd / ref.sd - 1.0).abs().max())}


def judge(values: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit; a number that is not finite fails."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(values[k] == values[k] and values[k] <= limits[k] for k in NUMBERS)
    return ok, checks
