"""Defaults shared by the port's solvers.

fgp_dual_dtype: storage type of the FGP dual fields P1..P3 between the
fused FGP kernel launches (tv/cuda_fgp.py). The dual-ball projection keeps
|P| <= 1, so bfloat16 storage costs ~2^-9 relative per component and the
denoised volume moves by ~lam * 1e-2 absolute at most, while the kernel
reads and writes 40% fewer bytes. All arithmetic stays float32. Pass
``dual_dtype=torch.float32`` to the FGP functions for strict f32 results.
"""

from __future__ import annotations

import torch

fgp_dual_dtype = torch.bfloat16
