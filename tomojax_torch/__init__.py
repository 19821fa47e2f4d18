"""tomojax_torch -- the PyTorch/CUDA port of tomojax for NVIDIA Hopper.

It sits beside ``tomojax`` (the JAX reference it is tested against) and
imports neither JAX nor ``tomojax``. Tensors stay on the device the
caller puts them on: on the CPU every kernel wrapper runs its plain
PyTorch version; on a CUDA device it runs the hand-written kernels in
``csrc/``, which are compiled with nvcc for sm_90a at first use into
``build/tomojax_torch/`` (see ``_build.py``).
"""

from tomojax_torch.api import ChemicalTomo, Simulator, TomoTorch
from tomojax_torch.geometry import Geometry
from tomojax_torch.stream import DynamicReconstructor

__version__ = "0.1.0"

__all__ = ["ChemicalTomo", "DynamicReconstructor", "Geometry", "Simulator",
           "TomoTorch", "__version__"]
