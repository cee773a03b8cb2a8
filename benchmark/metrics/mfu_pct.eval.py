"""The whole eval's share of the chip's peak: the model's operations (both
towers' convs and heads at the bf16 peak, the match at the TF32 peak), as
time at peak, over the traced window."""


def read(summary, work):
    if not summary["kernels"] or not work.get("model_ops_s"):
        return None
    return 100.0 * work["model_ops_s"] / summary["window_s"]
