"""The ConvNeXt blocks' MLP (fc1, GELU, fc2, the layer scale and the
residual add, span ``convnext.mlp``): the least time of its work at the
cell's shapes (``benchmark.work.convnext``: the two products' FLOPs at the
bf16 peak of 989 TFLOP/s, or their bytes at 3.35 TB/s where larger, call by
call) over the summed device stretches of the program's ``convnext.mlp``
spans. Spans, not kernel names: a kernel that fuses the MLP's epilogues is
measured against the same work."""

SPAN, LAYER = "convnext.mlp", "convnext_mlp"


def read(summary, work):
    from benchmark import program_spans

    records = program_spans.window()
    spent = records and program_spans.device_seconds(records, SPAN)
    layer = (work or {}).get("layers", {}).get(LAYER)
    if not spent or not layer:
        return None
    return 100.0 * layer["least_s"] / spent
