"""The public names of witw_tpu_torch.models, as witw_tpu.models exports them."""

from witw_tpu_torch.models.baseline import BaselineEncoder
from witw_tpu_torch.models.fov_dsm import FovDsm, fov_dsm_trainable_mask
from witw_tpu_torch.models.backbones.vgg16 import Vgg16Features
from witw_tpu_torch.models.safa import SafaHead, VggSafa, safa_trainable_mask

__all__ = [
    "BaselineEncoder",
    "FovDsm",
    "fov_dsm_trainable_mask",
    "Vgg16Features",
    "SafaHead",
    "VggSafa",
    "safa_trainable_mask",
]
