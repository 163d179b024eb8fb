"""Spherical-harmonic synthesis and isotropic noise (port of the synthesis
half of graph_weather_tpu/ops/sht.py).

The associated Legendre tables are NumPy copies, built on the host once per
(grid, lmax); synthesis is then two small einsums, which is XLA in the JAX
package and plain PyTorch here. Conventions are those of the JAX package:
orthonormal real harmonics, coefficients [..., lmax, mmax] of the cos(m phi)
and sin(m phi) harmonics.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _legendre_table(lmax: int, mmax: int, cos_theta: np.ndarray) -> np.ndarray:
    """Orthonormalized associated Legendre Nbar_lm P_l^m at given points.

    Returns [mmax, lmax, n_theta] (zero where m > l), by the standard stable
    recurrence on the fully normalized functions.
    """
    x = np.asarray(cos_theta, dtype=np.float64)
    n = x.shape[0]
    sin_theta = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    table = np.zeros((mmax, lmax, n), dtype=np.float64)

    # P̄_00 = 1/sqrt(4π); P̄_mm = -sqrt((2m+1)/(2m)) sinθ P̄_{m-1,m-1}
    pmm = np.full(n, 1.0 / np.sqrt(4.0 * np.pi))
    for m in range(mmax):
        if m > 0:
            pmm = -np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * sin_theta * pmm
        if m < lmax:
            table[m, m] = pmm
        # P̄_{m+1,m} = sqrt(2m+3) x P̄_mm
        if m + 1 < lmax:
            table[m, m + 1] = np.sqrt(2.0 * m + 3.0) * x * pmm
        for ell in range(m + 2, lmax):
            a = np.sqrt((4.0 * ell * ell - 1.0) / (ell * ell - m * m))
            b = np.sqrt(((ell - 1.0) ** 2 - m * m) / (4.0 * (ell - 1.0) ** 2 - 1.0))
            table[m, ell] = a * (x * table[m, ell - 1] - b * table[m, ell - 2])
    return table


@lru_cache(maxsize=8)
def _synthesis_tables(nlat: int, nlon: int, lmax: int, mmax: int):
    """(leg [mmax, lmax, nlat], cos(m phi) [mmax, nlon], sin(m phi)), f32 NumPy."""
    theta = np.pi * (np.arange(nlat) + 0.5) / nlat
    leg = _legendre_table(lmax, mmax, np.cos(theta))
    phi = 2.0 * np.pi * np.arange(nlon) / nlon
    m = np.arange(mmax)
    cosmphi = np.cos(m[:, None] * phi[None, :])
    sinmphi = np.sin(m[:, None] * phi[None, :])
    return leg.astype(np.float32), cosmphi.astype(np.float32), sinmphi.astype(np.float32)


@lru_cache(maxsize=8)
def _device_tables(nlat: int, nlon: int, lmax: int, mmax: int, device: torch.device):
    return tuple(
        torch.as_tensor(t, device=device) for t in _synthesis_tables(nlat, nlon, lmax, mmax)
    )


def isht(
    coeffs_cos: torch.Tensor, coeffs_sin: torch.Tensor, nlat: int, nlon: int
) -> torch.Tensor:
    """Real SH synthesis: [..., lmax, mmax] coefficient pairs -> [..., nlat, nlon].

    coeffs_sin's column m=0 is ignored.
    """
    lmax, mmax = coeffs_cos.shape[-2], coeffs_cos.shape[-1]
    leg, cosmphi, sinmphi = _device_tables(nlat, nlon, lmax, mmax, coeffs_cos.device)
    gc = torch.einsum("...lm,mlt->...mt", coeffs_cos, leg)
    gs = torch.einsum("...lm,mlt->...mt", coeffs_sin, leg)
    scale = torch.full((mmax,), 2.0**0.5, dtype=gc.dtype, device=gc.device)
    scale[0] = 1.0
    field = torch.einsum("...mt,mp,m->...tp", gc, cosmphi, scale)
    sin_scale = scale * (torch.arange(mmax, device=gc.device) > 0)
    return field + torch.einsum("...mt,mp,m->...tp", gs, sinmphi, sin_scale)


def noise_lmax(num_lon: int, num_lat: int) -> int:
    """lmax of the isotropic noise on a 2N x N or 2N x (N+1) grid."""
    if 2 * num_lat == num_lon:
        return num_lat
    if 2 * (num_lat - 1) == num_lon:
        return num_lat - 1
    raise ValueError(
        "Isotropic noise requires grid's shape to be 2N x N or 2N x (N+1): "
        f"got {num_lon} x {num_lat}."
    )


def generate_isotropic_noise(
    generator: torch.Generator,
    num_lon: int,
    num_lat: int,
    num_samples: int = 1,
) -> torch.Tensor:
    """Isotropic unit-variance noise field [num_lon, num_lat, num_samples].

    iid N(0, 4 pi / lmax^2) coefficients over the orthonormal real harmonics
    up to lmax, which gives pointwise variance 1 exactly. Drawn from
    `generator`, on the generator's device.
    """
    device = generator.device
    lmax = mmax = noise_lmax(num_lon, num_lat)
    sigma = (4.0 * np.pi) ** 0.5 / lmax
    tri = torch.tril(torch.ones((lmax, mmax), device=device))  # only m <= l modes
    shape = (num_samples, lmax, mmax)
    coeffs_cos = torch.randn(shape, generator=generator, device=device) * sigma * tri
    coeffs_sin = torch.randn(shape, generator=generator, device=device) * sigma * tri
    field = isht(coeffs_cos, coeffs_sin, num_lat, num_lon)  # [S, nlat, nlon]
    return field.permute(2, 1, 0)  # [lon, lat, samples]
