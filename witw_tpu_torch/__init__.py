"""witw_tpu_torch — PyTorch/CUDA port of witw_tpu's FOV-DSM inference slice
and its static-int8 serving path.

The JAX package ``witw_tpu`` is the reference; this package mirrors its module
layout and public names, keeps NHWC at public boundaries, and runs on an
NVIDIA H100 (sm_90a) with four kernels written by hand in CUDA (``csrc/``):
the fused correlation + chord-distance match, and for the static-int8
towers the int8 3x3 conv with its requant epilogue, the 2x2 max pool and
VGG block 2 fused into one pass. Everything else is plain PyTorch (cuDNN
convs, cuBLAS GEMMs, ``torch.fft``).

- ``ops``        — FOV crop, normalization, polar transform, fused match,
                   and the int8 conv, max pool and fused block-2 wrappers.
- ``models``     — VGG16 FOV-DSM towers, the flax -> torch weight bridge,
                   and the static-int8 path (``models.quantize``).
- ``match``      — circular correlation, chord distance, FFT matcher.
- ``kernels``    — nvcc build + ctypes loading of ``csrc/``.
- ``evaluation`` — single-device gallery rank sweep and metrics.
- ``train``      — the inference half of the FOV pipeline, embed + test.

Configs are shared with the JAX package (``witw_tpu.configs`` is plain
dataclasses). This package imports no JAX.
"""

__version__ = "0.1.0"
