"""witw_tpu_torch — PyTorch/CUDA port of witw_tpu's FOV-DSM inference slice,
its training, and its static-int8 serving path.

The JAX package ``witw_tpu`` is the reference; this package mirrors its module
layout and public names, keeps NHWC at public boundaries, and runs on an
NVIDIA H100 (sm_90a) with eight kernel libraries written by hand in CUDA
(``csrc/``): the fused correlation + chord-distance match, the bf16 3x3
conv + bias + ReLU of the bf16 towers, for the static-int8 towers the int8
3x3 conv with its requant epilogue, the 2x2 max pool and VGG block 2 fused
into one pass, and for the int8 profiling harness (``exp``) kernel A with
stages removed, the ``mma.sync`` rate probe and the layout probes.
Everything else is plain PyTorch (cuDNN for the stride-2 head convs and the
backward, cuBLAS GEMMs, ``torch.fft``).

- ``configs``    — the port's copy of witw_tpu's config dataclasses and the
                   FOV-DSM presets.
- ``ops``        — FOV crop, normalization, polar transform, fused match,
                   the bf16 conv, and the int8 conv, max pool and fused
                   block-2 wrappers.
- ``models``     — VGG16 FOV-DSM towers, the flax -> torch weight bridge,
                   and the static-int8 path (``models.quantize``).
- ``match``      — circular correlation, chord distance, DSM triplet loss,
                   FFT matcher.
- ``kernels``    — nvcc build + ctypes loading of ``csrc/``.
- ``evaluation`` — single-device gallery rank sweep and metrics, the
                   gallery index.
- ``data``       — CSV registry, decode / resize, the pair loader,
                   synthetic data.
- ``train``      — the FOV pipeline (train, eval and embed steps), the
                   train/val loop, checkpoints, embed + test, the metric
                   writer.
- ``tools``      — build_index, the serving daemon, the heatmap sweep and
                   its native GeoTIFF binding (``native/geotiff_io.cpp``,
                   built with g++ at first use).
- ``cli``        — the FOV and semantic training / test CLIs:
                   ``python -m witw_tpu_torch.cli.cvig_fov``.
- ``utils``      — device selection, the step timer, CUDA-event timing,
                   profiler traces.
- ``exp``        — the int8 profiling harness, counterparts of the root
                   ``exp/`` probes: ``python3 -m witw_tpu_torch.exp.<name>``.

This package imports no JAX and no module of ``witw_tpu``. Its entry points
run on the CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
