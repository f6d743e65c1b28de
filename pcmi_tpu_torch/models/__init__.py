"""The port's model zoo and training loops: the reference's exported
names, each from the module of the same path."""

from pcmi_tpu_torch.models.unet import (
    DIPUNet,
    InpaintUNet,
    PatchDiscriminator,
    SRUNet,
    bicubic_upsample,
)
from pcmi_tpu_torch.models.dip import DIPConfig, DIPEngine
from pcmi_tpu_torch.models.training import (
    InpaintGANTrainer,
    InpaintTrainConfig,
    SRGANTrainer,
    SRTrainConfig,
    data_parallel_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "DIPUNet",
    "InpaintUNet",
    "PatchDiscriminator",
    "SRUNet",
    "bicubic_upsample",
    "DIPConfig",
    "DIPEngine",
    "InpaintGANTrainer",
    "InpaintTrainConfig",
    "SRGANTrainer",
    "SRTrainConfig",
    "data_parallel_step",
    "restore_checkpoint",
    "save_checkpoint",
]
