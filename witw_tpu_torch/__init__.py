"""witw_tpu_torch — PyTorch/CUDA port of witw_tpu's FOV-DSM inference slice.

The JAX package ``witw_tpu`` is the reference; this package mirrors its module
layout and public names, keeps NHWC at public boundaries, and runs on an
NVIDIA H100 (sm_90a) with the fused correlation + chord-distance kernel
written by hand in CUDA (``csrc/fused_match.cu``). Everything else is plain
PyTorch (cuDNN convs, cuBLAS GEMMs, ``torch.fft``).

- ``ops``        — FOV crop, normalization, polar transform, fused match.
- ``models``     — VGG16 FOV-DSM towers and the flax -> torch weight bridge.
- ``match``      — circular correlation, chord distance, FFT matcher.
- ``kernels``    — nvcc build + ctypes loading of ``csrc/``.
- ``evaluation`` — single-device gallery rank sweep and metrics.
- ``train``      — the inference half of the FOV pipeline, embed + test.

Configs are shared with the JAX package (``witw_tpu.configs`` is plain
dataclasses). This package imports no JAX.
"""

__version__ = "0.1.0"
