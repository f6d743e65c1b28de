"""Carry state from ``pcmi_tpu`` objects into the port's.

Nothing here imports JAX or ``pcmi_tpu``: arrays are read through
``np.asarray`` (which a JAX array supports), records through their
attributes, an RPC camera through its float64 tag dict. So a scene, a pair
selection or a running DSM that the reference started can be carried
over and finished by the port. A reference config becomes the port's own
through :func:`config_from_reference`, a reference U-Net's or detector
head's or diffusion network's Flax parameters the port network's
``state_dict`` through :func:`unet_state_dict`,
:func:`centernet_state_dict` and :func:`diffusion_state_dict`, and a training
run of the reference (networks, optax Adam moments, step) a port
trainer's state through :func:`gan_state_from_reference` and
:func:`detector_state_from_reference`.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from pcmi_tpu_torch import config

from pcmi_tpu_torch.geometry.affine import LocalFrame
from pcmi_tpu_torch.geometry.pairs import ImageMeta
from pcmi_tpu_torch.geometry.rpc import RPCCamera
from pcmi_tpu_torch.geometry.synthetic import SyntheticScene
from pcmi_tpu_torch.models.detector import CenterNetHead
from pcmi_tpu_torch.models.diffusion import CondUNet
from pcmi_tpu_torch.models.unet import PatchDiscriminator
from pcmi_tpu_torch.pipelines.streaming import StreamingDSM


def rpc_from_reference(d: dict) -> RPCCamera:
    """RPC camera from the GDAL-style float64 tag dict that
    ``pcmi_tpu.geometry.rpc.RPCCamera.from_dict`` keeps as ``cam._f64``."""
    return RPCCamera.from_dict(d)


def scene_from_arrays(images, terrain, ground_origin, ground_gsd: float,
                      frame_lonlat, rpc_dicts, h_range) -> SyntheticScene:
    """A :class:`SyntheticScene` from the reference scene's arrays:
    ``images`` (per view, (H, W)), ``terrain`` (Hg, Wg), the ground origin
    and gsd, the frame anchor ``(lon0, lat0)`` and each view's RPC dict.
    Cameras, per-view truth and the texture are not carried."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy())

    return SyntheticScene(
        images=[t(im) for im in images],
        heights=[],
        cameras=[],
        rpcs=[rpc_from_reference(d) for d in rpc_dicts],
        frame=LocalFrame(lon0=float(frame_lonlat[0]),
                         lat0=float(frame_lonlat[1])),
        terrain=t(terrain),
        texture=None,
        ground_gsd=float(ground_gsd),
        ground_origin=tuple(float(v) for v in ground_origin),
        h_range=tuple(h_range))


def tensor_from_reference(a) -> torch.Tensor:
    """A reference array as a CPU tensor of the same element type. numpy
    has no bfloat16 of its own, so such an array travels through float32
    (every bfloat16 value is a float32 value: exact both ways)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def metas_from_reference(metas) -> list[ImageMeta]:
    """The port's :class:`ImageMeta` records from the reference's."""
    return [ImageMeta(index=int(m.index),
                      incidence_deg=float(m.incidence_deg),
                      azimuth_deg=float(m.azimuth_deg), date=float(m.date),
                      name=str(m.name))
            for m in metas]


def streaming_dsm_from_reference(acc, device="cuda") -> StreamingDSM:
    """A reference ``StreamingDSM`` (running weight, value and square
    sums) as the port's float32 tensors on ``device``, ready for the
    port's ``dsm_update`` and ``dsm_finalize``."""
    return StreamingDSM(*(
        torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
        for a in (acc.wsum, acc.vsum, acc.vsq)))


def config_from_reference(cfg):
    """The port's config equal to a reference config (``StereoConfig``,
    ``PipelineConfig`` or any other class of :mod:`pcmi_tpu_torch.config`),
    rebuilt field by field, nested configs included."""
    cls = getattr(config, type(cfg).__name__, None)
    if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)):
        raise TypeError(f"no port config class for {type(cfg).__name__}")
    return cls(**{
        f.name: (config_from_reference(v)
                 if dataclasses.is_dataclass(v := getattr(cfg, f.name)) else v)
        for f in dataclasses.fields(cfg)})


# Flax leaf -> (port suffix, array): 2-D kernels HWIO to OIHW, 1-D (K, I,
# O) to (O, I, K), dense (I, O) to (O, I)
_LEAVES = {
    "conv": {"kernel": ("weight", (3, 2, 0, 1)), "bias": ("bias", None)},
    "conv1d": {"kernel": ("weight", (2, 1, 0)), "bias": ("bias", None)},
    "dense": {"kernel": ("weight", (1, 0)), "bias": ("bias", None)},
    "embed": {"embedding": ("weight", None)},
}


def _flax_state_dict(params, model: torch.nn.Module, layout) -> dict:
    """A ``state_dict`` of ``model`` from a Flax parameter tree (with or
    without its ``"params"`` level; numpy leaves): ``layout`` lists
    ``(port prefix, Flax name, kind)``, kind one of ``_LEAVES`` (a 2-D or
    1-D convolution, a dense layer, an embedding), "block" (a
    ``ConvBlock``: ``Conv_0``, ``Conv_1``) or a nested layout of the
    same form for a submodule. Raises ``KeyError`` on a parameter left
    over or missing on either side, ``ValueError`` on a shape that
    differs from the network's."""
    out = {}

    def leaf(prefix, kind, node):
        spec = _LEAVES[kind]
        if set(node) != set(spec):
            raise KeyError(f"{prefix}: Flax {kind} keys {sorted(node)}")
        for key, (name, axes) in spec.items():
            a = np.asarray(node[key], np.float32)
            out[f"{prefix}.{name}"] = torch.from_numpy(
                (a if axes is None else a.transpose(axes)).copy())

    def walk(tree, layout):
        for prefix, name, kind in layout:
            if name not in tree:
                raise KeyError(f"no Flax parameters {name!r}")
            node = tree[name]
            if kind == "block":
                walk(node, [(prefix + ".conv0", "Conv_0", "conv"),
                            (prefix + ".conv1", "Conv_1", "conv")])
            elif isinstance(kind, list):
                walk(node, [(f"{prefix}.{p}", n, k) for p, n, k in kind])
            else:
                leaf(prefix, kind, node)
        left = set(tree) - {name for _, name, _ in layout}
        if left:
            raise KeyError(f"Flax parameters left over: {sorted(left)}")

    walk(dict(params.get("params", params)), layout)
    want = model.state_dict()
    if set(want) != set(out):
        raise KeyError(f"state_dict keys differ: missing "
                       f"{sorted(set(want) - set(out))}, unexpected "
                       f"{sorted(set(out) - set(want))}")
    for k, v in out.items():
        if v.shape != want[k].shape:
            raise ValueError(f"{k}: shape {tuple(v.shape)} from Flax, "
                             f"{tuple(want[k].shape)} in the network")
    return out


def _unet_layout(L: int):
    """The U-Net part of a layout: L widths, ``Conv_`` counted from 0."""
    layout = [(f"enc.{i}", f"ConvBlock_{i}", "block") for i in range(L - 1)]
    layout.append(("mid", f"ConvBlock_{L - 1}", "block"))
    for j in range(L - 1):
        layout += [(f"ups.{j}", f"Conv_{j}", "conv"),
                   (f"dec.{j}", f"ConvBlock_{L + j}", "block")]
    layout.append(("head", f"Conv_{L - 1}", "conv"))
    return layout


def unet_state_dict(params, model: torch.nn.Module) -> dict:
    """The ``state_dict`` of a port network (:class:`InpaintUNet`,
    :class:`SRUNet`, :class:`DIPUNet` or :class:`PatchDiscriminator`) from
    the reference's Flax parameters of the same network (``model.init``'s
    tree, with or without its ``"params"`` level; numpy leaves).

    Kernels go from HWIO to OIHW. Flax names a parent's submodules by
    their order of creation in its compact scope: a U-Net of L widths has
    ``ConvBlock_0 .. ConvBlock_{L-2}`` (encoder), ``ConvBlock_{L-1}``
    (bottleneck), then per decoder level j the upsampling ``Conv_j`` and
    ``ConvBlock_{L+j}``, and the 1x1 head last, ``Conv_{L-1}``; the
    PatchGAN has ``Conv_0 ..`` with its head last. Raises ``KeyError`` on
    a parameter left over or missing on either side, ``ValueError`` on a
    shape that differs from the network's. A tree of Adam moments of the
    same network (``mu``, ``nu``) maps the same way."""
    if isinstance(model, PatchDiscriminator):
        n = len(model.convs)
        layout = [(f"convs.{i}", f"Conv_{i}", "conv") for i in range(n)]
        layout.append(("head", f"Conv_{n}", "conv"))
    else:
        layout = _unet_layout(len(model.widths))
    return _flax_state_dict(params, model, layout)


def diffusion_state_dict(params, model: CondUNet) -> dict:
    """The ``state_dict`` of a port :class:`CondUNet` from the reference's
    Flax parameters of the same network. Beside the U-Net's names (see
    :func:`unet_state_dict`) Flax has ``Embed_0`` (the class embedding),
    ``TextEncoder_0`` (``Embed_0``, the kernel-3 ``Conv_0``, ``Dense_0``)
    and one ``Dense_k`` per encoder level and the bottleneck, in creation
    order. Kernels go from HWIO to OIHW, a 1-D convolution's (3, in, out)
    to (out, in, 3), a dense layer's (in, out) to (out, in). Raises as
    :func:`unet_state_dict` does."""
    L = len(model.widths)
    layout = []
    if model.class_embed is not None:
        layout.append(("class_embed", "Embed_0", "embed"))
    if model.text is not None:
        layout.append(("text", "TextEncoder_0", [
            ("embed", "Embed_0", "embed"), ("conv", "Conv_0", "conv1d"),
            ("dense", "Dense_0", "dense")]))
    layout += [(f"enc_temb.{i}", f"Dense_{i}", "dense") for i in range(L - 1)]
    layout.append(("mid_temb", f"Dense_{L - 1}", "dense"))
    return _flax_state_dict(params, model, layout + _unet_layout(L))


def centernet_state_dict(params, model: CenterNetHead) -> dict:
    """The ``state_dict`` of the port's :class:`CenterNetHead` from the
    reference's Flax parameters (or Adam moments) of the same head:
    ``ConvBlock_0 .. ConvBlock_3`` (the trunk), then the 1x1 heads
    ``Conv_0`` heat, ``Conv_1`` size, ``Conv_2`` offset and, with an
    angle head, ``Conv_3`` angle. Raises as :func:`unet_state_dict`."""
    layout = [(f"blocks.{i}", f"ConvBlock_{i}", "block") for i in range(4)]
    heads = ["heat", "size", "offset"] + (["angle"] if model.with_angle
                                          else [])
    layout += [(h, f"Conv_{i}", "conv") for i, h in enumerate(heads)]
    return _flax_state_dict(params, model, layout)


def _adam_state(opt_state):
    """``(count, mu, nu)`` of an optax Adam state: the element of the
    chain's state that holds the moments."""
    todo = [opt_state]
    while todo:
        s = todo.pop(0)
        if all(hasattr(s, f) for f in ("count", "mu", "nu")):
            return int(np.asarray(s.count)), s.mu, s.nu
        if isinstance(s, (tuple, list)):
            todo.extend(s)
    raise TypeError("no Adam moments (count, mu, nu) in the optimiser state")


def _load_adam(opt: torch.optim.Optimizer, model: torch.nn.Module,
               to_state_dict, opt_state) -> None:
    """Set ``opt`` (a ``torch.optim.Adam`` over ``model.parameters()``)
    to the reference's optax Adam state: the moments ``mu`` and ``nu`` as
    ``exp_avg`` and ``exp_avg_sq``, its count as every parameter's
    ``step``."""
    count, mu, nu = _adam_state(opt_state)
    m, v = to_state_dict(mu, model), to_state_dict(nu, model)
    sd = opt.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(count)),
                       "exp_avg": m[name], "exp_avg_sq": v[name]}
                   for i, (name, _) in enumerate(model.named_parameters())}
    opt.load_state_dict(sd)


def gan_state_from_reference(state, trainer):
    """The port's :class:`~pcmi_tpu_torch.models.training.GANState` on
    ``trainer.device`` from a reference ``GANState`` of the same networks
    (its Flax parameters, its two optax Adam states and its step), so that
    a run the reference trained resumes in the port's ``trainer`` (an
    ``InpaintGANTrainer`` or ``SRGANTrainer``)."""
    nets = []
    for net, params in ((trainer.gen, state.g_params),
                        (trainer.disc, state.d_params)):
        net = copy.deepcopy(net)
        net.load_state_dict(unet_state_dict(params, net))
        nets.append(net.to(trainer.device))
    out = trainer.optimizers(*nets, step=int(np.asarray(state.step)))
    _load_adam(out.g_opt, out.g, unet_state_dict, state.g_opt)
    _load_adam(out.d_opt, out.d, unet_state_dict, state.d_opt)
    return out


def detector_state_from_reference(params, opt_state, trainer):
    """``(net, opt)`` for the port's detector ``trainer``
    (``DetectorTrainer`` or ``OBBDetectorTrainer``) from the reference's
    ``(params, opt)`` of the same head: the network on ``trainer.device``
    and its ``torch.optim.Adam`` holding the reference's moments."""
    net = copy.deepcopy(trainer.model)
    net.load_state_dict(centernet_state_dict(params, net))
    net = net.to(trainer.device)
    opt = trainer.optimizer(net)
    _load_adam(opt, net, centernet_state_dict, opt_state)
    return net, opt
