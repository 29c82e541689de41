"""Trevor on PyTorch: the port of the stream-pipeline configuration system
to PyTorch and CUDA on NVIDIA Hopper.

Subpackages mirror the JAX reference package's names (``core``,
``streams``, ``kernels``) so every module has one counterpart.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve_device`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
