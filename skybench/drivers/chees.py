"""Whitened ChEES on the crowded field's joint posterior, the flow of the
program's ``bench/config5.py``: a windowed diagonal HMC warmup, a short NUTS
probe, the pooled dense metric and the whitened space, a z-space HMC
warmup, the ChEES (eps, T) adaptation, then frozen-parameter ChEES
segments (``inference.run_chees_ensemble``) for the measured window.

Every call goes through the program's public inference functions; the
harness keeps the probe's draws (the reference pools them again) and, at
each segment's end, the states of a sample of chains.
"""

from __future__ import annotations

import time

import torch

from skybench.trace import span


class Arm:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.traffic = ctx.config, ctx.traffic
        self.chains = int(self.traffic["chains"])
        self.max_leapfrog = int(self.traffic["max_leapfrog"])

    def setup(self):
        """Everything before the window; ends with the adapted state."""
        from celeste_tpu_torch import inference as inf

        ctx, p = self.ctx, self.cfg["prep"]
        logd, dev = ctx.logd, ctx.device
        gen = ctx.streams.torch("prep", dev)
        d = int(ctx.truth.shape[0])
        jitter = torch.randn((self.chains, d), generator=ctx.streams.torch("start", dev),
                             device=dev)
        x0 = ctx.truth[None, :] + float(self.cfg["start_jitter"]) * jitter
        with torch.no_grad():
            with ctx.phase("warmup"):
                carry = inf.hmc_warmup_init(x0, logd, init_step_size=p["init_step_size"])
                for off in range(0, p["n_warmup"], p["warmup_window"]):
                    carry = inf.hmc_warmup_window(
                        gen, logd, carry, min(p["warmup_window"], p["n_warmup"] - off),
                        n_warmup=p["n_warmup"], n_leapfrog=p["warmup_leapfrog"])
                states, ss, im = inf.hmc_warmup_finish(carry)
                step = float(torch.quantile(ss, 0.5))
                inv_mass = torch.mean(im, dim=0)
            with ctx.phase("probe"):
                probe = inf.nuts_kernel(logd, step_size=step, inv_mass=inv_mass,
                                        max_depth=p["probe_max_depth"])
                self.probe_draws, _, _ = inf.run_chains_ensemble(gen, probe, states,
                                                                 n_steps=p["probe_steps"])
            with ctx.phase("whiten"):
                m_hat, cov_hat = inf.ensemble_covariance(self.probe_draws,
                                                         ridge=p["probe_ridge"])
                self.logd_z, self.to_x, to_z = inf.whiten_logdensity(logd, m_hat, cov_hat)
            with ctx.phase("zwarm"):
                carry = inf.hmc_warmup_init(to_z(states.x), self.logd_z,
                                            init_step_size=p["zwarm_init_step_size"])
                carry = inf.hmc_warmup_window(gen, self.logd_z, carry, p["n_zwarm"],
                                              n_warmup=p["n_zwarm"],
                                              n_leapfrog=p["zwarm_leapfrog"])
                states_z, ss_z, _ = inf.hmc_warmup_finish(carry)
                step_z = float(torch.quantile(ss_z, 0.5))
            with ctx.phase("chees_adapt"):
                t = self.traffic
                gen_a = ctx.streams.torch("chees_adapt", dev)
                carry = inf.chees_warmup_init(states_z.x, self.logd_z, init_step_size=step_z)
                for off in range(0, t["adapt_iters"], t["adapt_window"]):
                    carry = inf.chees_warmup_window(
                        gen_a, self.logd_z, carry,
                        n_iters=min(t["adapt_window"], t["adapt_iters"] - off),
                        init_step_size=step_z, max_leapfrog=self.max_leapfrog)
                self.state, eps, traj = inf.chees_warmup_finish(carry)
                self.eps, self.traj = float(eps), float(traj)
        ctx.log(f"prep: HMC step {step:.5f}, z step {step_z:.5f}, ChEES eps {self.eps:.5f} "
                f"T {self.traj:.5f} (~{self.traj / self.eps:.1f} leapfrogs a step)")
        self.gen = ctx.streams.torch("window", dev)
        self.check_rows = torch.randperm(self.chains, generator=ctx.streams.torch("check", "cpu"))
        self.check_rows = self.check_rows[:int(self.traffic["check_rows"])].to(dev)
        self.steps_done = 0
        self.samples, self.segment_states, self.n_leap, self.divergence = [], [], [], []
        self.bad = []

    def _segment(self, n_steps, logd_z=None):
        from celeste_tpu_torch.inference import chees

        samples, self.state, info = chees.run_chees_ensemble(
            self.gen, logd_z or self.logd_z, self.state, n_steps=n_steps, step_size=self.eps,
            trajectory_length=self.traj, max_leapfrog=self.max_leapfrog,
            start_iter=self.steps_done)
        self.steps_done += n_steps
        st, rows = self.state, self.check_rows
        self.segment_states.append((st.xs[rows], st.logps[rows], st.grads[rows]))
        self.bad.append((~(torch.isfinite(st.logps) & torch.isfinite(st.grads).all(1))).sum()
                        * n_steps)
        self.n_leap.append(info.n_leapfrog)
        self.divergence.append(info.divergence_rate)
        return samples

    def window(self, seconds: float) -> dict:
        """Frozen-parameter segments until ``seconds`` of host time are
        spent; the window ends when the device has finished them."""
        ctx, seg = self.ctx, int(self.traffic["segment_steps"])
        self.start_z = self.state.xs.clone()
        ctx.sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            while True:
                self.samples.append(self._segment(seg))
                if time.perf_counter() - t0 >= seconds:
                    break
            ctx.sync()
        wall = time.perf_counter() - t0
        leaps = torch.cat(self.n_leap).to(torch.float64)
        return {"seconds": wall, "steps": self.steps_done,
                "chain_transitions": self.steps_done * self.chains,
                "grad_evals": float(leaps.sum()),
                "chain_grad_evals": float(leaps.sum()) * self.chains,
                "divergence_share": float(torch.cat(self.divergence).double().mean()),
                "failed": int(torch.stack(self.bad).sum())}

    def traced(self, steps: int) -> float:
        """``steps`` more steps, one call each, with the log density and each
        step in a span; returns the value-and-gradient evaluations done."""
        def logd_z(z, inner=self.logd_z):
            with span("logdensity"):
                return inner(z)

        before = len(self.n_leap)
        with torch.no_grad():
            for _ in range(steps):
                with span("sampler_step"):
                    self._segment(1, logd_z)
        return float(torch.cat(self.n_leap[before:]).double().sum())

    def grad_ms(self, calls: int) -> float:
        """Mean host ms of the program's ``value_and_grad`` at the last
        states, each call ended by a device synchronize."""
        from celeste_tpu_torch.inference.hmc import value_and_grad

        xs, sync = self.state.xs, self.ctx.sync
        value_and_grad(self.logd_z, xs)
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            value_and_grad(self.logd_z, xs)
            sync()
        return (time.perf_counter() - t0) * 1e3 / calls

    def draws_x(self):
        """The window's draws in x, [chains, steps, D] (float64)."""
        z = torch.cat(self.samples, dim=1)
        return self.to_x(z).double()

    def check_inputs(self) -> dict:
        """What the comparison needs: the probe's draws, the sample rows'
        states at each segment's end, the final states of every chain,
        whether each chain moved during the window, and the window's draws
        pooled over chains and steps (their count and the float64 sums of z
        and of z z^T)."""
        st = self.state
        n, s1, s2 = 0, 0.0, 0.0
        for seg in self.samples:
            flat = seg.reshape(-1, seg.shape[-1]).double()
            n, s1, s2 = n + flat.shape[0], s1 + flat.sum(0), s2 + flat.T @ flat
        return {"probe_draws": self.probe_draws, "ridge": self.cfg["prep"]["probe_ridge"],
                "segment_states": self.segment_states[:-1],
                "final": (st.xs, st.logps, st.grads),
                "moved": (st.xs != self.start_z).any(dim=1), "draws": (n, s1, s2)}
