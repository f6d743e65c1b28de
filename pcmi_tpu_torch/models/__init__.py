"""The port's model zoo: the reference's exported names whose modules
are ported (the U-Nets' forward passes). The trainers, DIP and diffusion
are not ported yet."""

from pcmi_tpu_torch.models.unet import (
    DIPUNet,
    InpaintUNet,
    PatchDiscriminator,
    SRUNet,
    bicubic_upsample,
)

__all__ = [
    "DIPUNet",
    "InpaintUNet",
    "PatchDiscriminator",
    "SRUNet",
    "bicubic_upsample",
]
