"""No-U-Turn Sampler, iterative with a fixed-size trajectory buffer,
batch-major (counterpart of ``celeste_tpu/inference/nuts.py``).

Multinomial NUTS with biased progressive sampling (Hoffman & Gelman 2014;
Betancourt 2017 §A.3), in the JAX package's iterative form:

- the trajectory lives in a ring buffer of 2^max_depth states per chain
  (time t maps to slot t mod 2^max_depth, exact because a trajectory never
  exceeds 2^max_depth states), so no recursion and no checkpoint stack;
- each doubling round j runs 2^j leapfrog steps with a streaming
  multinomial candidate inside the new subtree;
- the balanced-subtree U-turn checks of the recursive algorithm are one
  vectorised pass per level over the subtree's stored states;
- U-turn criterion: dot(x+ - x-, v±) < 0 with velocity v = M^-1 p.

Every tensor holds all chains ([B, ...]): each chain has its own direction,
``lo``/``hi``, candidate, divergence flag and ``done`` mask.  A round
computes every chain and keeps the result only for chains that are not done,
so a finished chain stops changing, exactly as the JAX kernel's per-chain
``lax.cond`` leaves it; the rounds stop once every chain is done.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from celeste_tpu_torch.inference.hmc import HMCState, value_and_grad

_DIVERGENCE_THRESHOLD = 1000.0


class NUTSInfo(NamedTuple):
    logp: torch.Tensor          # [B]
    accept_prob: torch.Tensor   # [B] mean Metropolis statistic over the generated leaves
    diverged: torch.Tensor      # [B] bool
    tree_depth: torch.Tensor    # [B] int
    n_leapfrog: torch.Tensor    # [B] int


def _where(mask, new, old):
    """Per-chain select of [B] or [B, ...] tensors by a [B] mask."""
    return torch.where(mask.reshape(-1, *([1] * (new.dim() - 1))), new, old)


def nuts_kernel(logdensity_fn, step_size, inv_mass, max_depth: int = 8):
    """Build a NUTS step ``(generator, HMCState) -> (HMCState, NUTSInfo)``
    over a batched log density.  ``inv_mass`` is the [D] diagonal inverse
    mass, ``step_size`` a scalar shared by all chains."""
    size = 2 ** max_depth

    def step(gen, state: HMCState):
        x0 = state.x
        b, d = x0.shape
        kw = dict(dtype=x0.dtype, device=x0.device)
        im = torch.as_tensor(inv_mass, **kw)
        rows = torch.arange(b, device=x0.device)

        def kinetic(p):
            return 0.5 * torch.sum(im * p * p, dim=-1)

        def uniform():
            return torch.rand(b, generator=gen, **kw)

        p0 = torch.randn((b, d), generator=gen, **kw) / torch.sqrt(im)
        energy0 = -state.logp + kinetic(p0)
        xs = torch.zeros((b, size, d), **kw)
        ps = torch.zeros((b, size, d), **kw)
        xs[:, 0], ps[:, 0] = x0, p0
        c = dict(lo=torch.zeros(b, dtype=torch.long, device=x0.device),
                 hi=torch.zeros(b, dtype=torch.long, device=x0.device),
                 x_left=x0, p_left=p0, grad_left=state.grad,
                 x_right=x0, p_right=p0, grad_right=state.grad,
                 x_prop=x0, logp_prop=state.logp, grad_prop=state.grad,
                 log_sum_w=torch.zeros(b, **kw),          # weight of the initial state: exp(0)
                 diverged=torch.zeros(b, dtype=torch.bool, device=x0.device),
                 sum_metro=torch.zeros(b, **kw), n_metro=torch.zeros(b, **kw),
                 depth=torch.zeros(b, dtype=torch.long, device=x0.device),
                 n_leapfrog=torch.zeros(b, dtype=torch.long, device=x0.device))
        done = torch.zeros(b, dtype=torch.bool, device=x0.device)

        for j in range(max_depth):
            active = ~done
            if not bool(active.any()):
                break
            length = 2 ** j
            go_right = uniform() < 0.5
            eps = torch.where(go_right, step_size, -step_size).to(x0.dtype)[:, None]
            x = _where(go_right, c["x_right"], c["x_left"])
            p = _where(go_right, c["p_right"], c["p_left"])
            g = _where(go_right, c["grad_right"], c["grad_left"])

            lsw_sub = torch.full((b,), -float("inf"), **kw)
            xp, lpp, gp = c["x_prop"], c["logp_prop"], c["grad_prop"]
            div_sub = torch.zeros(b, dtype=torch.bool, device=x0.device)
            sm, nm = c["sum_metro"], c["n_metro"]
            for i in range(length):
                p_half = p + 0.5 * eps * g
                x = x + eps * im * p_half
                logp, g = value_and_grad(logdensity_fn, x)
                p = p_half + 0.5 * eps * g
                energy = -logp + kinetic(p)
                log_w = energy0 - energy
                log_w = torch.where(torch.isfinite(log_w), log_w,
                                    torch.full_like(log_w, -float("inf")))
                # negated <= so NaN energies also count as divergences
                div_sub = div_sub | ~((energy - energy0) <= _DIVERGENCE_THRESHOLD)
                t = torch.where(go_right, c["hi"] + 1 + i, c["lo"] - 1 - i)
                slot = torch.remainder(t, size)
                xs[rows, slot] = x
                ps[rows, slot] = p
                # streaming multinomial candidate within the new subtree
                lsw_new = torch.logaddexp(lsw_sub, log_w)
                take = torch.log(uniform()) < (log_w - lsw_new)
                xp, lpp, gp = _where(take, x, xp), _where(take, logp, lpp), _where(take, g, gp)
                sm = sm + torch.clamp(torch.exp(log_w), max=1.0)
                nm = nm + 1.0
                lsw_sub = lsw_new

            # balanced-subtree U-turn checks over the stored leaves, all levels
            turning_sub = torch.zeros(b, dtype=torch.bool, device=x0.device)
            if length >= 2:
                t0 = torch.where(go_right, c["hi"] + 1, c["lo"] - length)
                slots = torch.remainder(t0[:, None] + torch.arange(length, device=x0.device), size)
                xs_sub = xs[rows[:, None], slots]           # [B, L, D], ascending time
                ps_sub = ps[rows[:, None], slots]
                for level in range(1, j + 1):
                    bl = 2 ** level
                    xb = xs_sub.reshape(b, length // bl, bl, d)
                    pb = ps_sub.reshape(b, length // bl, bl, d)
                    dx = xb[:, :, -1] - xb[:, :, 0]
                    bad = ((torch.sum(dx * im * pb[:, :, 0], -1) < 0.0)
                           | (torch.sum(dx * im * pb[:, :, -1], -1) < 0.0))
                    turning_sub = turning_sub | bad.any(dim=1)
            ok = ~(turning_sub | div_sub)

            # merge (biased progressive sampling): the proposal takes the
            # subtree's candidate with probability min(1, W_sub / W_old)
            take_sub = (torch.log(uniform()) < (lsw_sub - c["log_sum_w"])) & ok
            grow_left = ok & ~go_right
            grow_right = ok & go_right
            new = dict(
                lo=torch.where(grow_left, c["lo"] - length, c["lo"]),
                hi=torch.where(grow_right, c["hi"] + length, c["hi"]),
                x_left=_where(grow_left, x, c["x_left"]),
                p_left=_where(grow_left, p, c["p_left"]),
                grad_left=_where(grow_left, g, c["grad_left"]),
                x_right=_where(grow_right, x, c["x_right"]),
                p_right=_where(grow_right, p, c["p_right"]),
                grad_right=_where(grow_right, g, c["grad_right"]),
                x_prop=_where(take_sub, xp, c["x_prop"]),
                logp_prop=_where(take_sub, lpp, c["logp_prop"]),
                grad_prop=_where(take_sub, gp, c["grad_prop"]),
                log_sum_w=torch.where(ok, torch.logaddexp(c["log_sum_w"], lsw_sub),
                                      c["log_sum_w"]),
                diverged=c["diverged"] | div_sub,
                sum_metro=sm, n_metro=nm,
                depth=torch.where(ok, c["depth"] + 1, c["depth"]),
                n_leapfrog=c["n_leapfrog"] + length,
            )
            dx = new["x_right"] - new["x_left"]
            turning_full = ((torch.sum(dx * im * new["p_left"], -1) < 0.0)
                            | (torch.sum(dx * im * new["p_right"], -1) < 0.0))
            # a chain that was done keeps its carry: this round never ran for it
            c = {k: _where(active, v, c[k]) for k, v in new.items()}
            done = done | (active & (~ok | turning_full))

        new_state = HMCState(x=c["x_prop"], logp=c["logp_prop"], grad=c["grad_prop"])
        info = NUTSInfo(logp=c["logp_prop"],
                        accept_prob=c["sum_metro"] / torch.clamp(c["n_metro"], min=1.0),
                        diverged=c["diverged"], tree_depth=c["depth"],
                        n_leapfrog=c["n_leapfrog"])
        return new_state, info

    return step
