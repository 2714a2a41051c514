"""pulseportraiture_tpu_torch: wideband pulsar timing in PyTorch and CUDA.

A port of ``pulseportraiture_tpu`` (the JAX reference, kept beside it in
this repository) to PyTorch, with the hot device functions written by
hand in CUDA C++ for NVIDIA Hopper (``csrc/``, built at first use by
``_kernels``).  The layout mirrors the JAX package file for file:

  io/        PSRFITS + model-file + TOA-file I/O (host, numpy)
  ops/       portrait array math (torch tensors, batched)
  fit/       Fourier-domain fits; the moment and FFTFIT kernels
  pipelines/ the wideband pptoas pipeline
  cli/       the pptoas command line
  utils/     records, MJDs, telescope codes, ephemerides

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device they raise (config.default_device).
Importing the package touches no device.
"""

from . import config  # noqa: F401
from .utils.databunch import DataBunch  # noqa: F401

__version__ = "0.1.0"
