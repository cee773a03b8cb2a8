"""witw_tpu_torch — the PyTorch/CUDA port of witw_tpu, for an NVIDIA H100.

The JAX package ``witw_tpu`` is the reference. This package does what it
does: the four tower families (FOV-DSM, semantic, baseline and SAFA) in
bf16 and in static and dynamic int8, their training on one device or data
parallel across processes, retrieval eval, the gallery indexes, the
heatmap sweep, the serving daemon and the dataset tools. It mirrors
witw_tpu's module layout: every subpackage exports the names of its
witw_tpu counterpart's ``__all__``. NHWC at the public boundaries.

Eight kernel libraries are written by hand in CUDA C++ for sm_90a
(``csrc/``): the fused correlation + chord-distance match (3xTF32 on
``wgmma``), the bf16 3x3 conv + bias + ReLU of the bf16 towers (``wgmma``),
for the static-int8 towers the int8 3x3 conv with its requant epilogue
(s8 ``wgmma``), the 2x2 max pool and VGG block 2 fused into one pass (s8
``wgmma``), and for the int8 profiling harness (``exp``) kernel A with
stages removable and the s8 / bf16 rate probe, both on ``wgmma``, and the
layout probes on TMA tensor-map copies. Everything else is plain PyTorch
(cuDNN for the other convs and the backward, cuBLAS GEMMs, ``torch.fft``).

- ``configs``    — the port's copy of witw_tpu's config dataclasses and the
                   presets of the four families.
- ``ops``        — image normalization and bilinear resize, FOV crop,
                   polar transform, synced rotation, orientation maps, and
                   the wrappers of the hand-written kernels.
- ``models``     — the VGG16 FOV-DSM and SAFA towers, the baseline's
                   7-conv GeM towers, the flax and .pth weight bridges, and
                   the int8 paths (``models.quantize``).
- ``match``      — circular correlation, orientation estimate, chord
                   distance (streaming, and the materialized oracle of
                   ``match.reference_impl``), match scores, triplet losses,
                   the FFT matcher.
- ``parallel``   — device meshes, placement and sharding of batches and
                   galleries, collectives across ``torch.distributed``
                   processes, data-parallel training.
- ``kernels``    — nvcc build + ctypes loading of ``csrc/``.
- ``evaluation`` — gallery rank sweeps (fused or FFT, on one device or
                   sharded over a mesh), Euclidean ranks, the metrics, and
                   the gallery and vector indexes.
- ``data``       — CSV registry, decode / resize, the pair loader and its
                   per-process sharded form, synthetic data.
- ``train``      — the pipelines of the four families (train, eval and
                   embed steps), the train/val loop, checkpoints, embed +
                   test, the metric writer.
- ``tools``      — build_index, the serving daemon, the heatmap sweep and
                   its native GeoTIFF binding (``native/geotiff_io.cpp``,
                   built with g++ at first use); the dataset tools (8-bit
                   conversion, UTM reprojection, tiles, road masks,
                   build_dataset), the Flickr scraper and the recall-parity
                   harness.
- ``cli``        — the training / test CLIs of the four families:
                   ``python -m witw_tpu_torch.cli.cvig_fov`` and the like.
- ``utils``      — device selection, the step timer, CUDA-event and
                   CUDA-graph timing, profiler traces, the weights
                   fingerprint, a flax-checkpoint reader.
- ``exp``        — the int8 profiling harness, counterparts of the root
                   ``exp/`` probes: ``python3 -m witw_tpu_torch.exp.<name>``.

This package imports no JAX and no module of ``witw_tpu``. Its entry points
run on the CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
