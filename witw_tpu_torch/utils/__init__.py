"""The public names of witw_tpu_torch.utils, as witw_tpu.utils exports them."""

from witw_tpu_torch.utils.profiling import StepTimer, trace_profile

__all__ = ["StepTimer", "trace_profile"]
