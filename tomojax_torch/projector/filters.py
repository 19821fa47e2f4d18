"""FBP/WBP filter bank (counterpart of ``tomojax/projector/filters.py``).

The filter responses are the reference's numpy code, copied (the port
cannot import ``tomojax``), so both packages build the same float32
response for every name: the band-limited ramp kernel ``h[0] = 1/4,
h[odd n] = -1/(pi n)^2, h[even] = 0`` (Kak & Slaney, Ch. 3) times a
smoothing window on the normalised frequency ``u = |f|/f_nyq`` in [0, 1].
The window formulas, and the three parameter choices the names do not
pin (kaiser beta 4, gaussian sigma 1/3, tukey alpha 0.5), are documented
in the reference module.

`filter_sinogram` filters the slice-last sinogram (Na, Nt, Ns) along its
detector axis, dim 1: zero-padded to the response's length, one
``torch.fft.rfft``, the response, one ``irfft``, cut back to Nt. The
reference filters with ``jnp.fft`` outside any Pallas kernel; on the card
``torch.fft`` runs cuFFT.
"""

from __future__ import annotations

import numpy as np
import torch


def _window(name: str, u: np.ndarray) -> np.ndarray:
    """Smoothing window on normalized frequency u in [0, 1]."""
    pi = np.pi
    if name in ("ram-lak", "ramlak"):
        return np.ones_like(u)
    if name == "shepp-logan":
        return np.sinc(u / 2.0)
    if name == "cosine":
        return np.cos(pi * u / 2.0)
    if name == "hamming":
        return 0.54 + 0.46 * np.cos(pi * u)
    if name in ("hann", "hanning"):
        return 0.5 * (1.0 + np.cos(pi * u))
    if name == "tukey":
        alpha = 0.5
        w = np.ones_like(u)
        m = u > (1.0 - alpha)
        w[m] = 0.5 * (1.0 + np.cos(pi * (u[m] - (1.0 - alpha)) / alpha))
        return w
    if name == "lanczos":
        return np.sinc(u)
    if name == "triangular":
        return 1.0 - u
    if name == "gaussian":
        sigma = 1.0 / 3.0
        return np.exp(-0.5 * (u / sigma) ** 2)
    if name in ("barlett-hann", "bartlett-hann"):
        return 0.62 - 0.24 * u + 0.38 * np.cos(pi * u)
    if name == "blackman":
        return 0.42 + 0.5 * np.cos(pi * u) + 0.08 * np.cos(2 * pi * u)
    if name == "nuttall":
        return (
            0.355768
            + 0.487396 * np.cos(pi * u)
            + 0.144232 * np.cos(2 * pi * u)
            + 0.012604 * np.cos(3 * pi * u)
        )
    if name == "blackman-harris":
        return (
            0.35875
            + 0.48829 * np.cos(pi * u)
            + 0.14128 * np.cos(2 * pi * u)
            + 0.01168 * np.cos(3 * pi * u)
        )
    if name == "blackman-nuttall":
        return (
            0.3635819
            + 0.4891775 * np.cos(pi * u)
            + 0.1365995 * np.cos(2 * pi * u)
            + 0.0106411 * np.cos(3 * pi * u)
        )
    if name == "flat-top":
        return (
            0.21557895
            + 0.41663158 * np.cos(pi * u)
            + 0.277263158 * np.cos(2 * pi * u)
            + 0.083578947 * np.cos(3 * pi * u)
            + 0.006947368 * np.cos(4 * pi * u)
        )
    if name == "kaiser":
        beta = 4.0
        return np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - u**2))) / np.i0(beta)
    if name == "parzen":
        w = np.where(
            u <= 0.5, 1.0 - 6.0 * u**2 * (1.0 - u), 2.0 * (1.0 - u) ** 3
        )
        return w
    raise ValueError(f"unknown FBP filter: {name!r}")


# Full ASTRA-parity list (tomoengine.cpp:317-321) plus 'none' (plain BP).
FILTERS = (
    "none",
    "ram-lak",
    "shepp-logan",
    "cosine",
    "hamming",
    "hann",
    "tukey",
    "lanczos",
    "triangular",
    "gaussian",
    "barlett-hann",
    "blackman",
    "nuttall",
    "blackman-harris",
    "blackman-nuttall",
    "flat-top",
    "kaiser",
    "parzen",
)


def _ramp_response(m: int) -> np.ndarray:
    """rFFT of the band-limited ramp kernel of length m (even)."""
    h = np.zeros(m)
    h[0] = 0.25
    nn = np.arange(1, m // 2 + 1)
    odd = nn[nn % 2 == 1]
    h[odd] = -1.0 / (np.pi * odd) ** 2
    h[-odd] = -1.0 / (np.pi * odd) ** 2
    return np.real(np.fft.rfft(h))


def make_filter(name: str, nray: int) -> tuple[np.ndarray, int]:
    """Precompute the frequency response; returns (response, padded_len)."""
    m = max(64, int(2 ** np.ceil(np.log2(2 * nray))))
    resp = _ramp_response(m)
    freqs = np.fft.rfftfreq(m)  # cycles/sample in [0, 0.5]
    u = freqs / 0.5
    if name != "ram-lak":
        resp = resp * _window(name, u)
    return resp.astype(np.float32), m


def filter_sinogram(sino: torch.Tensor,
                    name: str = "ram-lak") -> torch.Tensor:
    """Apply the named FBP filter along the detector axis (dim 1) of a
    slice-last sinogram (Na, Nt, Ns); "none" returns `sino` itself. The
    angular integration factor is applied by the FBP solver
    (``solvers/wbp.py``), not here."""
    if name == "none":
        return sino
    nray = sino.shape[1]
    resp, m = make_filter(name, nray)
    f = torch.fft.rfft(sino, n=m, dim=1)
    f = f * torch.as_tensor(resp, device=sino.device)[None, :, None]
    out = torch.fft.irfft(f, n=m, dim=1)
    return out[:, :nray].to(sino.dtype).contiguous()
