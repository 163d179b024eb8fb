"""GenCast diffusion sampler: DPMSolver++2S with stochastic churn.

Port of graph_weather_tpu/models/gencast/sampler.py (Karras Alg. 2
churn/inflation + Lu et al. DPMSolver++2S midpoint steps, final Euler
step). The JAX package runs the trajectory inside one `lax.scan`; here it is
a Python loop over the denoiser. Per-step isotropic noise comes from an
explicit `torch.Generator` on the sampler's device. A num_steps trajectory
makes 2 (num_steps - 2) + 1 denoiser evaluations.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from graph_weather_tpu_torch.ops.sht import generate_isotropic_noise


class Sampler:
    """Sampler over a Denoiser handle, on `device` ("cuda" unless the caller
    asks for "cpu"); the denoiser must live on the same device."""

    def __init__(
        self,
        S_noise: float = 1.05,
        S_tmin: float = 0.75,
        S_tmax: float = 80.0,
        S_churn: float = 2.5,
        r: float = 0.5,
        sigma_max: float = 80.0,
        sigma_min: float = 0.03,
        rho: float = 7,
        num_steps: int = 20,
        device="cuda",
    ):
        self.S_noise = S_noise
        self.S_tmin = S_tmin
        self.S_tmax = S_tmax
        self.S_churn = S_churn
        self.r = r
        self.sigma_max = sigma_max
        self.sigma_min = sigma_min
        self.rho = rho
        self.num_steps = num_steps
        self.device = torch.device(device)

    def sigmas(self) -> torch.Tensor:
        """The num_steps noise levels, f32, from sigma_max down to sigma_min."""
        u = torch.arange(self.num_steps, dtype=torch.float32) / (self.num_steps - 1)
        hi, lo = self.sigma_max ** (1 / self.rho), self.sigma_min ** (1 / self.rho)
        return (hi + u * (lo - hi)) ** self.rho

    def _check_device(self, denoiser) -> None:
        if denoiser.device != self.device:
            raise ValueError(
                f"sampler on {self.device}, denoiser on {denoiser.device}: "
                "build both on one device"
            )

    def _noise(self, generator: torch.Generator, denoiser, batch: int) -> torch.Tensor:
        """[B, lon, lat, F_out] isotropic noise, independent per batch entry."""
        return torch.stack(
            [
                generate_isotropic_noise(
                    generator,
                    num_lon=denoiser.num_lon,
                    num_lat=denoiser.num_lat,
                    num_samples=denoiser.output_features_dim,
                )
                for _ in range(batch)
            ]
        )

    @torch.no_grad()
    def _traj(
        self,
        denoiser,
        prev_inputs: torch.Tensor,
        init_noise: torch.Tensor,
        churn_noises: Sequence[torch.Tensor],
    ) -> torch.Tensor:
        """The DPMSolver++2S trajectory over explicit per-step noise: one
        init_noise [B, lon, lat, F] and num_steps - 1 churn noises (S_noise
        inflation is applied here). `sample` and `sample_injected` both run
        this function."""
        sigmas = [float(s) for s in self.sigmas()]
        gamma_const = min(self.S_churn / self.num_steps, 2**0.5 - 1)
        batch = prev_inputs.shape[0]
        ones = torch.ones((batch, 1), device=self.device)
        x = sigmas[0] * init_noise

        def churn(x, noise, sigma_i):
            gamma = gamma_const if self.S_tmin <= sigma_i <= self.S_tmax else 0.0
            sigma_hat = sigma_i * (gamma + 1.0)
            x = x + math.sqrt(max(sigma_hat**2 - sigma_i**2, 0.0)) * (self.S_noise * noise)
            return x, sigma_hat

        for i in range(self.num_steps - 2):
            # DPMSolver++2S midpoint step (all but the last iteration).
            x, sigma_hat = churn(x, churn_noises[i], sigmas[i])
            sigma_next = sigmas[i + 1]
            denoised = denoiser(x, prev_inputs, sigma_hat * ones)
            h = math.log(sigma_hat) - math.log(sigma_next)
            sigma_mid = math.exp(-(-math.log(sigma_hat) + self.r * h))
            u = sigma_mid / sigma_hat * x - (math.exp(-self.r * h) - 1.0) * denoised
            denoised_2 = denoiser(u, prev_inputs, sigma_mid * ones)
            d = (1.0 - 1.0 / (2.0 * self.r)) * denoised + denoised_2 / (2.0 * self.r)
            x = sigma_next / sigma_hat * x - (math.exp(-h) - 1.0) * d
        # The final iteration is a single-eval Euler step.
        last = self.num_steps - 2
        x, sigma_hat = churn(x, churn_noises[last], sigmas[last])
        denoised = denoiser(x, prev_inputs, sigma_hat * ones)
        d = (x - denoised) / sigma_hat
        return x + d * (sigmas[self.num_steps - 1] - sigma_hat)

    def sample(self, denoiser, prev_inputs, generator: torch.Generator) -> torch.Tensor:
        """One residual sample [B, lon, lat, F_out] conditioned on the previous
        two steps prev_inputs [B, lon, lat, 2 F_in]; noise from `generator`,
        which must live on the sampler's device."""
        self._check_device(denoiser)
        prev_inputs = torch.as_tensor(prev_inputs, dtype=torch.float32, device=self.device)
        batch = prev_inputs.shape[0]
        noises = [self._noise(generator, denoiser, batch) for _ in range(self.num_steps)]
        return self._traj(denoiser, prev_inputs, noises[0], noises[1:])

    def sample_injected(self, denoiser, prev_inputs, init_noise, churn_noises) -> torch.Tensor:
        """The same trajectory with the per-step isotropic noise passed
        explicitly (un-inflated): init_noise [B, lon, lat, F] and
        churn_noises [num_steps - 1, B, lon, lat, F]. For parity against a
        reference run's noise draws and reproducible re-sampling."""
        self._check_device(denoiser)

        def dev(t):
            return torch.as_tensor(t, dtype=torch.float32, device=self.device)

        return self._traj(denoiser, dev(prev_inputs), dev(init_noise), dev(churn_noises))
