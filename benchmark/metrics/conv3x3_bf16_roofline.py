"""The bf16 towers' stride-1 convs (``csrc/conv3x3_bf16.cu``): the least
time of their algorithmic work at the cell's shapes (FLOPs at 989 TFLOP/s or
bytes at 3.35 TB/s, call by call) over the kernel's summed device time."""

KERNEL = "conv3x3_bf16_kernel"


def read(summary, work):
    from benchmark.trace import kernel_seconds

    spent = kernel_seconds(summary, KERNEL)
    layer = work["layers"].get("conv3x3_bf16")
    if not spent or not layer:
        return None
    return 100.0 * layer["least_s"] / spent
