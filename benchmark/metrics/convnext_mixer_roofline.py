"""The ConvNeXt blocks' token mixer (a block's depthwise conv and LayerNorm,
span ``convnext.mixer``): the least time of its work at the cell's shapes
(``benchmark.work.convnext``: its FLOPs at 989 TFLOP/s or its bytes at 3.35
TB/s, the block input read once and the bf16 output written once, call by
call) over the summed device stretches of the program's ``convnext.mixer``
spans. Spans, not kernel names: a kernel that fuses the mixer is measured
against the same work."""

SPAN, LAYER = "convnext.mixer", "convnext_mixer"


def read(summary, work):
    from benchmark import program_spans

    records = program_spans.window()
    spent = records and program_spans.device_seconds(records, SPAN)
    layer = (work or {}).get("layers", {}).get(LAYER)
    if not spent or not layer:
        return None
    return 100.0 * layer["least_s"] / spent
