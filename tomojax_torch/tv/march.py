"""The plane march of K7/K9c, K3/K9a, K11 and K5 on the card.

Python mirror of ``csrc/tv_march.cuh``: a block owns a tile of ``TV_T1``
rows (axis 1) x ``TV_T2`` voxels (axis 2) and walks ``TV_C`` planes of
axis 0, staging each plane with a halo of one voxel (K11: ``TV_H2``, two
iterations deep) on axes 1 and 2. The constants live in both languages;
change them together (``tests/test_torch_tv_tiles.py`` checks that they
agree).
"""

from __future__ import annotations

TV_T1 = 8   # tile rows (axis 1)
TV_T2 = 32  # tile voxels of a row (axis 2)
TV_C = 32   # planes (axis 0) a block marches
TV_H2 = 2   # K11's halo on axes 1 and 2 and planes below a chunk


def march_grid(n0: int, n1: int, n2: int) -> tuple[int, int, int]:
    """The launch grid (x, y, z) = (axis-2 tiles, axis-1 tiles, chunks)."""
    return (-(-n2 // TV_T2), -(-n1 // TV_T1), -(-n0 // TV_C))


def grad_partials(n0: int, n1: int, n2: int) -> int:
    """The ||g||^2 partials K7/K9c write: one a block, block (x, y, z) at
    (z * grid_y + y) * grid_x + x."""
    gx, gy, gz = march_grid(n0, n1, n2)
    return gx * gy * gz


def value_partials(nel: int, n0: int, n1: int, n2: int) -> int:
    """The partials K5 writes for nel elements of (n0, n1, n2): one a
    block of the march's grid with the elements' chunks along z (z =
    element * chunks + chunk), in K7's layout."""
    return nel * grad_partials(n0, n1, n2)
