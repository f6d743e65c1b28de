"""U-Net family as ``torch.nn`` modules (port of
``pcmi_tpu/models/unet.py``): inpainting generator, PatchGAN, SR U-Net,
DIP U-Net.

* :class:`InpaintUNet` — 4-level InstanceNorm U-Net over RGB+mask input,
  predicting a masked *residual*.
* :class:`PatchDiscriminator` — 70x70-receptive-field PatchGAN.
* :class:`SRUNet` — 3-level norm-free U-Net predicting a residual over the
  bicubic-upsampled input.
* :class:`DIPUNet` — the Deep-Image-Prior U-Net (encoder 64/128/128 with
  skips) with InstanceNorm.

Inputs and outputs are NHWC, as the reference's; the layers run NCHW.
Convolutions pad as Flax's ``padding="SAME"`` does (``_same_pads``:
asymmetric for even kernels, lo 1 / hi 2 for a 4x4 kernel at stride 1).
Torch needs each layer's input width up front, so every network takes an
``in_channels`` the reference infers at ``init``. Parameters are drawn
from a ``torch.Generator`` (by default a CPU one seeded with 0): Flax's
initialisers, a truncated normal of variance ``1 / fan_in`` for kernels
and zeros for biases, but not the reference's draw. Weights carried from
the reference go through :func:`pcmi_tpu_torch.convert.unet_state_dict`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def instance_norm(x: torch.Tensor, dims=(1, 2)) -> torch.Tensor:
    """Normalise over the spatial ``dims`` (NHWC: (1, 2); NCHW: (2, 3))
    with the population variance."""
    var, mu = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-5)


def _same_pads(n: int, k: int, s: int):
    """(lo, hi) padding of Flax's "SAME" for an axis of ``n``, kernel ``k``,
    stride ``s``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with Flax's "SAME" padding, worked out from each
    input's size. An odd kernel at stride 1 pads (k - 1) / 2 on every side,
    which the convolution does itself; other shapes pad first."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1):
        odd = kernel % 2 == 1 and stride == 1
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=(kernel - 1) // 2 if odd else 0)
        self._pads_itself = odd

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self._pads_itself:
            k, s = self.kernel_size[0], self.stride[0]
            (t, b), (l, r) = (_same_pads(x.shape[-2], k, s),
                              _same_pads(x.shape[-1], k, s))
            if t or b or l or r:
                x = F.pad(x, (l, r, t, b))
        return super().forward(x)


def _init_params(module: nn.Module,
                 generator: Optional[torch.Generator]) -> None:
    """Flax's default initialisers on every layer, in creation order:
    convolution and dense kernels truncated normal (at ±2 sigma) of
    variance ``1 / fan_in``, biases 0; embeddings normal of variance
    ``1 / features``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = float(np.sqrt(1.0 / fan_in) / .87962566103423978)
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0,
                                float(np.sqrt(1.0 / m.embedding_dim)),
                                generator=generator)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class ConvBlock(nn.Module):
    """Two 3x3 convolutions, each followed by instance norm (``norm``) and
    a leaky ReLU (0.2). NCHW."""

    def __init__(self, features: int, norm: bool = True,
                 in_features: Optional[int] = None):
        super().__init__()
        self.norm = norm
        self.conv0 = SameConv2d(in_features or features, features, 3)
        self.conv1 = SameConv2d(features, features, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.conv0, self.conv1):
            x = conv(x)
            if self.norm:
                x = instance_norm(x, (2, 3))
            x = _leaky(x)
        return x


def _down(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def _up(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """Nearest upsampling by 2 (NCHW), then ``conv``."""
    return conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _UNet(nn.Module):
    """Encoder of ``ConvBlock``s over ``widths[:-1]`` with 2x2 max pools,
    a ``widths[-1]`` bottleneck, a decoder of nearest upsampling + 3x3 conv
    + skip concatenation + ``ConvBlock``, and a 1x1 head."""

    def __init__(self, widths: Sequence[int], in_channels: int,
                 out_channels: int, norm: bool,
                 generator: Optional[torch.Generator]):
        super().__init__()
        widths = tuple(widths)
        self.widths = widths
        self.out_channels = out_channels
        chans = (in_channels,) + widths[:-2]
        self.enc = nn.ModuleList(ConvBlock(w, norm, c)
                                 for w, c in zip(widths[:-1], chans))
        self.mid = ConvBlock(widths[-1], norm, widths[-2])
        dec_w = widths[:-1][::-1]
        self.ups = nn.ModuleList(SameConv2d(c, w, 3) for w, c in
                                 zip(dec_w, (widths[-1],) + dec_w[:-1]))
        self.dec = nn.ModuleList(ConvBlock(w, norm, 2 * w) for w in dec_w)
        self.head = SameConv2d(widths[0], out_channels, 1)
        _init_params(self, generator)

    def _residual(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        h = x_nhwc.permute(0, 3, 1, 2)
        skips = []
        for blk in self.enc:
            h = blk(h)
            skips.append(h)
            h = _down(h)
        h = self.mid(h)
        for up, blk, skip in zip(self.ups, self.dec, reversed(skips)):
            h = blk(torch.cat([_up(h, up), skip], dim=1))
        return self.head(h).permute(0, 2, 3, 1)


class InpaintUNet(_UNet):
    """Residual inpainting generator; input (B, H, W, 4) = RGB(3)+mask(1).

    Output: ``input_rgb + tanh(head) * mask`` — the model only repaints the
    hole.
    """

    def __init__(self, widths: Sequence[int] = (32, 64, 128, 256),
                 out_channels: int = 3, in_channels: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(widths, in_channels or out_channels + 1,
                         out_channels, True, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rgb = x[..., : self.out_channels]
        mask = x[..., self.out_channels:][..., :1]
        return rgb + torch.tanh(self._residual(x)) * mask


class PatchDiscriminator(nn.Module):
    """PatchGAN: stride-2 conv stack -> (B, h', w', 1) real/fake logits."""

    def __init__(self, widths: Sequence[int] = (64, 128, 256, 512),
                 in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = tuple(widths)
        self.convs = nn.ModuleList(
            SameConv2d(c, w, 4, stride=2 if i < len(widths) - 1 else 1)
            for i, (w, c) in enumerate(zip(widths,
                                           (in_channels,) + widths[:-1])))
        self.head = SameConv2d(widths[-1], 1, 4)
        _init_params(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for i, conv in enumerate(self.convs):
            h = conv(h)
            if i > 0:
                h = instance_norm(h, (2, 3))
            h = _leaky(h)
        return self.head(h).permute(0, 2, 3, 1)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    """The linear-interpolation kernel, ``max(0, 1 - |x|)``."""
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _resize_weights(n_in: int, n_out: int, device,
                    kernel=_keys_cubic) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize`` along one axis:
    half-pixel centres, ``kernel`` widened by the scale when downsampling
    (antialiasing), weights outside the input dropped and the rest
    renormalised."""
    inv = np.float32(1.0 / (n_out / n_in))
    kscale = max(float(inv), 1.0)  # antialiasing widens only a downsample
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs() / kscale
    wts = kernel(x)
    total = wts.sum(dim=0, keepdim=True)
    wts = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, 0.0)


def image_resize(x: torch.Tensor, shape, method: str = "linear") -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` with its default antialiasing,
    for ``method`` "linear" or "cubic": every axis whose size changes is
    contracted with its weight matrix, in axis order, in float32."""
    kernel = {"linear": _triangle, "cubic": _keys_cubic}[method]
    out = x.float()
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in != n_out:
            w = _resize_weights(n_in, n_out, x.device, kernel)
            out = torch.movedim(torch.tensordot(out, w, dims=([d], [0])),
                                -1, d)
    return out


def bicubic_upsample(x: torch.Tensor, factor: int = 4) -> torch.Tensor:
    """NHWC bicubic resize by ``factor`` (``jax.image.resize``'s "cubic":
    one separable weight matrix per axis)."""
    b, h, w, c = x.shape
    wy = _resize_weights(h, h * factor, x.device)
    wx = _resize_weights(w, w * factor, x.device)
    out = torch.einsum("bhwc,hH->bHwc", x.float(), wy)
    return torch.einsum("bHwc,wW->bHWc", out, wx)


class SRUNet(_UNet):
    """4x super-resolution: residual over the bicubic upsample.

    Norm-free (the EDSR rationale): input is the bicubic-upsampled LR
    image; the net adds high-frequency detail.
    """

    def __init__(self, widths: Sequence[int] = (32, 64, 128),
                 out_channels: int = 3, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__(widths, in_channels, out_channels, False, generator)

    def forward(self, x_up: torch.Tensor) -> torch.Tensor:
        return x_up + self._residual(x_up)


class DIPUNet(_UNet):
    """Deep-Image-Prior U-Net over a fixed-noise input (B, H, W, in_ch=32):
    encoder 64/128/128 with skips, sigmoid output."""

    def __init__(self, widths: Sequence[int] = (64, 128, 128),
                 out_channels: int = 3, in_channels: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(widths, in_channels, out_channels, True, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self._residual(z))
