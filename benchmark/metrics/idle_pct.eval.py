"""The share of the traced eval window in which no operation runs on the
device (the window less the union of the device's intervals)."""


def read(summary, work):
    if not summary["kernels"]:
        return None
    return 100.0 * (summary["window_s"] - summary["busy_s"]) / summary["window_s"]
