"""The preprocess layer's share of the traced eval window: the summed device
stretches of the program's ``preprocess`` spans (each batch's casts, crop
roll, polar gather and normalizations, and any wait between their kernels)
over the window."""


def read(summary, work):
    from benchmark import program_spans

    records = program_spans.window()
    spent = records and program_spans.device_seconds(records, "preprocess")
    if not spent:
        return None
    return 100.0 * spent / summary["window_s"]
