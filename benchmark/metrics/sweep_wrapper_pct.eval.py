"""The gallery sweep's own cost on the stream, as a share of the traced eval
window: the summed device stretches of the program's ``rank`` spans less the
fused match kernel's device time, which leaves the threshold pass
(``rank.true``), the counting passes after each chunk, the counts' fetch and
any wait on the host."""


def read(summary, work):
    from benchmark import program_spans
    from benchmark.trace import kernel_seconds

    records = program_spans.window()
    ranked = records and program_spans.device_seconds(records, "rank")
    kernel = kernel_seconds(summary, "fused_corr_distance_kernel")
    if not ranked or not kernel:
        return None
    return 100.0 * (ranked - kernel) / summary["window_s"]
