"""tomojax_torch -- the PyTorch/CUDA port of tomojax for NVIDIA Hopper.

It sits beside ``tomojax`` (the JAX reference it is tested against) and
imports neither JAX nor ``tomojax``. Tensors stay on the device the
caller puts them on: on the CPU every kernel wrapper runs its plain
PyTorch version; on a CUDA device it runs the hand-written kernels in
``csrc/``, which are compiled with nvcc for sm_90a at first use into
``build/tomojax_torch/`` (see ``_build.py``).
"""

import torch

from tomojax_torch.api import ChemicalTomo, Simulator, TomoTorch
from tomojax_torch.geometry import Geometry
from tomojax_torch.stream import DynamicReconstructor

__version__ = "0.1.0"


def device_count() -> int:
    """The number of CUDA devices torch sees (tomofusion/__init__.py:10-18
    counts them with pycuda)."""
    return torch.cuda.device_count()


def determine_config(device_id: int = -1) -> str:
    """'singledevice' or 'multidevice', the reference's
    ``determine_gpu_config`` (tomofusion/__init__.py:21-34): a chosen
    device id, or at most one device, is 'singledevice'."""
    if device_id >= 0:
        return "singledevice"
    return "singledevice" if device_count() <= 1 else "multidevice"


__all__ = ["ChemicalTomo", "DynamicReconstructor", "Geometry", "Simulator",
           "TomoTorch", "determine_config", "device_count", "__version__"]
