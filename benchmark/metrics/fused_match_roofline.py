"""The gallery sweep's fused correlation and chord distance
(``csrc/fused_match.cu``): the least time of the f32 correlation counted once
at the TF32 tensor peak of 494.7 TFLOP/s (or its bytes at 3.35 TB/s), over
the kernel's summed device time. The yardstick does not follow the
implementation: a 3xTF32 split is still one correlation."""

KERNEL = "fused_corr_distance_kernel"


def read(summary, work):
    from benchmark.trace import kernel_seconds

    spent = kernel_seconds(summary, KERNEL)
    layer = work["layers"].get("fused_match")
    if not spent or not layer:
        return None
    return 100.0 * layer["least_s"] / spent
