"""Hand-written CUDA kernels of the port, each beside its plain version.

``KERNELS`` maps each kernel's name to its :class:`~repro_torch.kernels.
_build.Kernel`, whose ``launches`` counter shows which kernels a run went
through."""
from repro_torch.kernels.paged_attn.ops import KERNELS as _DECODE
from repro_torch.kernels.selective_attn.ops import KERNELS as _PREFILL

KERNELS = {k.name: k for k in _PREFILL + _DECODE}

__all__ = ["KERNELS"]
