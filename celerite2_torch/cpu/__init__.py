"""The native CPU driver: the host's eager tier.

Counterpart of ``celerite2_tpu.cpu``, with its own copy of ``driver.cpp``
built by g++ at first use into ``celerite2_torch/_build/``.
"""

from celerite2_torch.cpu.bindings import driver
from celerite2_torch.cpu.gp import NumpyGaussianProcess

__all__ = ["driver", "NumpyGaussianProcess"]
