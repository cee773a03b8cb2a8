"""The public names of witw_tpu_torch.utils, as witw_tpu.utils exports them,
and the program's spans (``profiling.span``, ``spans``, ``reset``)."""

from witw_tpu_torch.utils.profiling import StepTimer, reset, span, spans, trace_profile

__all__ = ["StepTimer", "trace_profile", "span", "spans", "reset"]
