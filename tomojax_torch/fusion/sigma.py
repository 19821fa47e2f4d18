"""Weighted element sum ("sigma") of multi-modal fusion (counterpart of
``tomojax/fusion/sigma.py``; its numpy tables are copied here, since
importing ``tomojax`` imports JAX).

The HAADF model voxel is the weighted sum over the elements of their
voxels, so sigma is a weighted reduction over the leading element axis and
sigma^T a broadcast: plain tensor ops, no kernel. The weighting methods
0..4 are the reference's fusion_helper.py:17-26.
"""

from __future__ import annotations

import numpy as np
import torch

# fusion_helper.py:34-48
PERIODIC_TABLE = {
    "h": 1, "he": 2, "li": 3, "be": 4, "b": 5, "c": 6, "n": 7, "o": 8,
    "f": 9, "ne": 10, "na": 11, "mg": 12, "al": 13, "si": 14, "p": 15,
    "s": 16, "cl": 17, "ar": 18, "k": 19, "ca": 20, "sc": 21, "ti": 22,
    "v": 23, "cr": 24, "mn": 25, "fe": 26, "co": 27, "ni": 28, "cu": 29,
    "zn": 30, "ga": 31, "ge": 32, "as": 33, "se": 34, "br": 35, "kr": 36,
    "rb": 37, "sr": 38, "y": 39, "zr": 40, "nb": 41, "mo": 42, "tc": 43,
    "ru": 44, "rh": 45, "pd": 46, "ag": 47, "cd": 48, "in": 49, "sn": 50,
    "sb": 51, "te": 52, "i": 53, "xe": 54, "cs": 55, "ba": 56, "la": 57,
    "ce": 58, "pr": 59, "nd": 60, "pm": 61, "sm": 62, "eu": 63, "gd": 64,
    "tb": 65, "dy": 66, "ho": 67, "er": 68, "tm": 69, "yb": 70, "lu": 71,
    "hf": 72, "ta": 73, "w": 74, "re": 75, "os": 76, "ir": 77, "pt": 78,
    "au": 79, "hg": 80, "tl": 81, "pb": 82, "bi": 83, "po": 84, "at": 85,
    "rn": 86, "fr": 87, "ra": 88, "ac": 89, "th": 90, "pa": 91, "u": 92,
    "np": 93, "pu": 94, "am": 95, "cm": 96, "bk": 97, "cf": 98, "es": 99,
    "fm": 100, "md": 101, "no": 102, "lr": 103, "rf": 104,
}


def element_weights(z_numbers, gamma: float, method: int = 0) -> np.ndarray:
    """Per-element weights w_e, float32 (fusion_helper.py:17-26 methods
    0..4); ValueError for any other method."""
    z = np.asarray(z_numbers, dtype=np.float64)
    if method == 0:
        w = np.ones_like(z)
    elif method == 1:
        w = z / np.mean(z)
    elif method == 2:
        w = z**gamma / np.mean(z**gamma)
    elif method == 3:
        w = z / np.sum(z)
    elif method == 4:
        w = z**gamma / np.sum(z**gamma)
    else:
        raise ValueError(f"unknown sigma method {method}")
    return w.astype(np.float32)


def weights_for_elements(elements, gamma: float,
                         method: int = 0) -> np.ndarray:
    """Weights from element symbols (chemistry/reconstructor.py:147-152)."""
    return element_weights([PERIODIC_TABLE[e.lower()] for e in elements],
                           gamma, method)


def sigma_apply(w, x: torch.Tensor) -> torch.Tensor:
    """sigma x: (Nel, ...) -> (...), the w-weighted sum over the elements."""
    w = torch.as_tensor(w, dtype=x.dtype, device=x.device)
    return torch.tensordot(w, x, dims=1)


def sigma_t_apply(w, v: torch.Tensor, nel: int) -> torch.Tensor:
    """sigma^T v: (...) -> (Nel, ...), v broadcast to each element scaled
    by w_e."""
    w = torch.as_tensor(w, dtype=v.dtype, device=v.device)
    return w.reshape((nel,) + (1,) * v.dim()) * v[None]
