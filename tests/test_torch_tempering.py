"""The port's parallel tempering (``celeste_tpu_torch.inference.tempering``)
against the JAX package's, on the CPU.

- The swap sweep against JAX's ``pt_kernel`` with an identity inner kernel,
  fed the uniforms JAX draws from the same keys: accept masks and the
  applied permutations exactly equal, xs and logps rtol 1e-6.
- ``geometric_ladder`` against JAX's: rtol 1e-6 (JAX computes it in
  float32 through XLA's ``pow``, which differs from torch's by a few ulp).
- ``hmc_at_beta``'s inflated step against JAX's expression
  (tempering.py:145-146), rtol 1e-6.
- On the bimodal 2-D target of tests/test_collectives.py:187, the cold
  chain's fraction in the positive mode within 0.1 of 0.5 for the mh, slice
  and hmc inners (16 systems, 8 temperatures).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.inference import tempering as jt
from celeste_tpu.inference.mh import MHState as JMHState

from celeste_tpu_torch.inference import tempering as tt
from celeste_tpu_torch.inference.hmc import value_and_grad
from celeste_tpu_torch.inference.mh import MHState
from celeste_tpu_torch.interop import pt_state_from_numpy

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

T, D, S = 8, 2, 16


def j_bimodal(x):
    return jnp.logaddexp(-0.5 * jnp.sum((x - 2.0) ** 2) / 0.3,
                         -0.5 * jnp.sum((x + 2.0) ** 2) / 0.3)


def t_bimodal(x):
    return torch.logaddexp(-0.5 * torch.sum((x - 2.0) ** 2, -1) / 0.3,
                           -0.5 * torch.sum((x + 2.0) ** 2, -1) / 0.3)


class _Uniforms:
    """``noise`` handing out given swap uniforms, one [S, T-1] per step."""

    def __init__(self, u):
        self.u, self.i = u, 0

    def uniform(self, gen, like):
        out = torch.tensor(self.u[self.i]).reshape(like.shape)
        self.i += 1
        return out


def test_swap_sweep_matches_jax_with_identity_inner():
    betas = jt.geometric_ladder(T, beta_min=0.05)

    def j_identity(beta):
        return jt._KernelBundle(init=lambda x, lp: JMHState(x=x, logp=beta * lp),
                                step=lambda k, s: (s, None))

    def t_identity(beta, idx):
        b = beta.reshape(-1)
        return tt.KernelBundle(init=lambda x, lp: MHState(x=x, logp=b * lp),
                               step=lambda g, s: (s, None))

    rng = np.random.default_rng(0)
    xs0 = (2.5 * rng.normal(size=(S, T, D))).astype(np.float32)
    j_kern = jax.jit(jax.vmap(jt.pt_kernel(j_bimodal, j_identity, betas)))
    j_state = jax.vmap(lambda x: jt.pt_init(x, j_bimodal))(jnp.asarray(xs0))
    n_steps = 12
    keys = [jax.random.split(jax.random.key(7 + i), S) for i in range(n_steps)]
    # the uniforms JAX's step draws: split(key) -> (k_move, k_swap)
    u = [np.asarray(jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[1], (T - 1,)))(k))
         for k in keys]
    t_kern = tt.pt_kernel(t_bimodal, t_identity, torch.tensor(np.asarray(betas)),
                          noise=_Uniforms(u))
    np.testing.assert_allclose(tt.pt_init(torch.as_tensor(xs0), t_bimodal).logps.numpy(),
                               np.asarray(j_state.logps), rtol=1e-6)
    # both ladders start from the same state, carried across as NumPy
    t_state = pt_state_from_numpy(np.asarray(j_state.xs), np.asarray(j_state.logps),
                                  bool(np.asarray(j_state.even_phase)[0]))
    n_accept = 0
    for k in keys:
        j_prev = np.asarray(j_state.xs)
        j_state, j_info = j_kern(k, j_state)
        t_state, t_info = t_kern(None, t_state)
        np.testing.assert_array_equal(t_info.swap_accept.numpy(), np.asarray(j_info.swap_accept))
        np.testing.assert_array_equal(t_info.swap_active.numpy(),
                                      np.asarray(j_info.swap_active)[0])
        assert t_state.even_phase == bool(np.asarray(j_state.even_phase)[0])
        np.testing.assert_allclose(t_state.xs.numpy(), np.asarray(j_state.xs), rtol=1e-6)
        np.testing.assert_allclose(t_state.logps.numpy(), np.asarray(j_state.logps), rtol=1e-6)
        np.testing.assert_allclose(t_info.logp_cold.numpy(), np.asarray(j_info.logp_cold),
                                   rtol=1e-6)
        # the permutation: every replica took its own or a neighbour's state
        moved = np.asarray(j_state.xs) != j_prev
        assert moved.any(-1).sum() == 2 * int(np.asarray(j_info.swap_accept).sum())
        n_accept += int(np.asarray(j_info.swap_accept).sum())
    assert n_accept > 0


def test_swap_sweep_is_a_pure_permutation():
    rng = np.random.default_rng(1)
    xs = torch.as_tensor(rng.normal(size=(3, T, D)), dtype=torch.float32)
    logps = torch.as_tensor(rng.normal(size=(3, T)), dtype=torch.float32)
    betas = tt.geometric_ladder(T, 0.05)
    for even in (True, False):
        u = torch.full((3, T - 1), 1e-30)            # accept every active pair
        new_xs, new_lp, accept, active = tt.swap_sweep(xs, logps, betas, even, u)
        assert torch.equal(accept, active.expand(3, T - 1))
        first = 0 if even else 1
        for i in range(first, T - 1, 2):
            assert torch.equal(new_xs[:, i], xs[:, i + 1]) and torch.equal(new_lp[:, i + 1],
                                                                           logps[:, i])
        if not even:
            assert torch.equal(new_xs[:, 0], xs[:, 0])


@pytest.mark.parametrize("n,beta_min", [(8, 0.02), (6, 0.02), (8, 0.05), (4, 0.02), (16, 0.01)])
def test_geometric_ladder_matches_jax(n, beta_min):
    np.testing.assert_allclose(tt.geometric_ladder(n, beta_min).numpy(),
                               np.asarray(jt.geometric_ladder(n, beta_min)), rtol=1e-6)


def test_hmc_at_beta_step_matches_jax():
    betas = jt.geometric_ladder(8, beta_min=1e-7)
    want = np.asarray(0.01 * jnp.minimum(jnp.maximum(betas, 1e-6) ** -0.25, 2.0))
    got = tt.tempered_step_size(0.01, torch.tensor(np.asarray(betas))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.max() == pytest.approx(0.02)          # the 2x cap bites at the hot end


def test_hmc_inner_reevaluates_the_gradient_on_entry():
    """Gradients are not carried across swaps: the HMC bundle's init takes
    the tempered target's gradient at the (permuted) position."""
    betas = tt.geometric_ladder(T, 0.05)
    beta = betas.expand(2, T)
    bundle = tt.hmc_at_beta(t_bimodal, 0.1, torch.ones(D))(beta, torch.arange(T).expand(2, T))
    x = torch.randn(2 * T, D, generator=torch.Generator().manual_seed(3))
    state = bundle.init(x, t_bimodal(x))
    _, want = value_and_grad(lambda v: beta.reshape(-1) * t_bimodal(v), x)
    assert torch.equal(state.grad, want)
    assert torch.equal(state.logp, beta.reshape(-1) * t_bimodal(x))


def _mode_fraction(inner, n_steps=400, burn=100, seed=0):
    betas = tt.geometric_ladder(T, 0.05)
    gen = torch.Generator().manual_seed(seed)
    state = tt.pt_init(2.5 * torch.randn((S, T, D), generator=gen), t_bimodal)
    kern = tt.pt_kernel(t_bimodal, inner, betas)
    cold, swaps = [], 0
    with torch.no_grad():
        for _ in range(n_steps):
            state, info = kern(gen, state)
            cold.append(state.xs[:, 0])
            swaps += int(info.swap_accept.sum())
    cold = torch.stack(cold, 1)[:, burn:]
    return float((cold[..., 0] > 0).double().mean()), swaps


@pytest.mark.parametrize("name", ["mh", "slice", "hmc"])
def test_bimodal_cold_chain_visits_both_modes(name):
    inner = {"mh": tt.mh_at_beta(t_bimodal, torch.full((D,), 0.4)),
             "slice": tt.slice_at_beta(t_bimodal, torch.full((D,), 1.0)),
             "hmc": tt.hmc_at_beta(t_bimodal, 0.2, torch.ones(D), n_leapfrog=8)}[name]
    frac, swaps = _mode_fraction(inner, n_steps=300 if name == "slice" else 400)
    assert swaps > 0
    assert abs(frac - 0.5) < 0.1, (name, frac)


def test_pt_warmup_and_adaptive_inner_shapes():
    """pt_warmup adapts one step size and mass per replica of every system,
    and hmc_at_beta_adaptive hands each row its replica's slot."""
    betas = tt.geometric_ladder(4, 0.05)
    gen = torch.Generator().manual_seed(5)
    xs0 = torch.randn((3, 4, D), generator=gen)
    with torch.no_grad():
        xs, ss, im = tt.pt_warmup(gen, t_bimodal, xs0, betas, n_warmup=30, n_leapfrog=4)
    assert xs.shape == (3, 4, D) and ss.shape == (3, 4) and im.shape == (3, 4, D)
    assert bool(torch.isfinite(ss).all()) and bool((ss > 0).all())
    idx = torch.arange(4).expand(3, 4)
    bundle = tt.hmc_at_beta_adaptive(t_bimodal, ss, im)(betas.expand(3, 4), idx)
    state = bundle.init(xs.reshape(-1, D), t_bimodal(xs).reshape(-1))
    with torch.no_grad():
        new, info = bundle.step(gen, state)
    assert new.x.shape == (12, D) and bool(torch.isfinite(new.logp).all())
