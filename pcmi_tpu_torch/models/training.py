"""Training loops: inpainting GAN, SR GAN, checkpointing (port of
``pcmi_tpu/models/training.py``).

* Inpaint GAN: per step, random hole masks, the prefilled (or
  zero-filled) hole as the generator's conditioning, a D hinge step, then
  a G step with L1 + gradient + ring + GAN losses through the updated D.
* SR GAN: MixGE reconstruction, with the GAN term switched on after
  ``warmup_steps``. D takes a step every time, with zero gradients during
  the warm-up, as the reference's optimiser does (its moments decay and
  its count advances).
* Checkpoints of any trainer state (a ``GANState``, a detector's
  ``(net, opt)``, a bare network, tuples of these): ``torch.save`` of the
  networks' and optimisers' ``state_dict``s, the schedules' counts and the
  step, read back with ``weights_only=True`` into a copy of a template.

The optimisers are ``torch.optim.Adam`` (``optax.adam``'s update: ``eps``
outside the square root, both bias corrections; ``b1 = 0.5`` for the
inpainting GAN). The inpainting trainer's cosine decay is a ``LambdaLR``
in closed form, read at the step count before each update as optax reads
its schedule. ``compute_dtype="bfloat16"`` rounds the networks' inputs to
bfloat16 and computes in float32 (what the reference's setting does:
Flax promotes a bfloat16 input to its float32 parameters); the rounding's
gradient is rounded on the way back as well. Convolutions run in float32
without TF32 on the card.

Everything runs on the trainer's ``device`` (default ``"cuda"``). Random
draws (initial weights, hole masks) come from CPU ``torch.Generator``s
and move to the device; :meth:`InpaintGANTrainer._step` takes the hole
masks from outside.

:func:`data_parallel_step` runs any trainer step of the port (the GAN
trainers' and the detectors') on each rank's shard of the batch, averages
every gradient over the data group before each optimiser step and divides
every loss summed over the batch by the whole batch's count, so each rank
takes exactly the whole batch's step up to the order of the sums (the
reference lets GSPMD compute every batch-global reduction, for any step).
It is not ``DistributedDataParallel``: the GAN steps update two networks
and pass the generator's output through the discriminator.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.optim.lr_scheduler import LambdaLR

from pcmi_tpu_torch.models.losses import (
    DATA_GROUP,
    hinge_d_loss,
    hinge_g_loss,
    mixge_loss,
    random_hole_masks,
    residual_inpaint_loss,
)
from pcmi_tpu_torch.models.unet import (
    InpaintUNet,
    PatchDiscriminator,
    SRUNet,
    _init_params,
    bicubic_upsample,
)
from pcmi_tpu_torch.ops.filters import masked_jacobi_fill_batch


class GANState(NamedTuple):
    """Both networks, their optimisers, the step count and, with a
    learning-rate schedule, its two ``LambdaLR``s (else ``None``)."""

    g: nn.Module
    d: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int
    g_sched: Optional[LambdaLR] = None
    d_sched: Optional[LambdaLR] = None


def _rounder(compute_dtype: str):
    if compute_dtype == "bfloat16":
        return lambda t: t.to(torch.bfloat16).float()
    if compute_dtype == "float32":
        return lambda t: t
    raise ValueError(f"compute_dtype {compute_dtype!r}")


def adam(params, device, **kw) -> torch.optim.Adam:
    """``torch.optim.Adam`` over ``params`` on ``device``: one fused kernel
    for all of them on the card, the multi-tensor form on the CPU."""
    return torch.optim.Adam(params, fused=torch.device(device).type == "cuda",
                            **kw)


def apply_gradients(opt: torch.optim.Optimizer, params,
                    loss: torch.Tensor) -> None:
    """One optimiser step on ``loss``'s gradients with respect to
    ``params`` only: every one of them gets a gradient (zeros where the
    loss does not depend on it), in its own memory layout, and no other
    parameter collects one. In a data-parallel step the gradients are
    averaged over the data group first."""
    opt.zero_grad(set_to_none=True)
    loss.backward(inputs=params)
    group = DATA_GROUP.get()
    if group is not None:
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= dist.get_world_size(group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view(g.shape))
    opt.step()


def cosine_decay(total_steps: int, alpha: float):
    """``optax.cosine_decay_schedule``'s factor at step ``k``, closed
    form: ``(1 - alpha) * (1 + cos(pi * min(k, total) / total)) / 2 +
    alpha``."""
    def factor(k: int) -> float:
        k = min(k, total_steps)
        return ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * k / total_steps))
                + alpha)
    return factor


def _schedule(opt: torch.optim.Optimizer, factor, step: int) -> LambdaLR:
    """A ``LambdaLR`` of ``factor`` whose next optimiser step is number
    ``step`` (counted from 0)."""
    for group in opt.param_groups:
        group.setdefault("initial_lr", group["lr"])
    return LambdaLR(opt, factor, last_epoch=step - 1)


def _fresh(net: nn.Module, rng: torch.Generator, device) -> nn.Module:
    """A copy of ``net`` on ``device`` with its weights drawn anew."""
    out = copy.deepcopy(net)
    _init_params(out, rng)
    return out.to(device)


@dataclasses.dataclass(frozen=True)
class InpaintTrainConfig:
    lr_g: float = 2e-4
    lr_d: float = 2e-4
    w_gan: float = 0.1
    w_grad: float = 0.5
    w_ring: float = 0.5
    mask_seeds: int = 6
    mask_steps: int = 10
    compute_dtype: str = "bfloat16"   # rounds the inputs; computes in float32
    # condition the generator on the Jacobi-prefilled hole (the residual
    # head learns the delta over a smooth baseline) instead of a zero fill
    prefill_condition: bool = True
    prefill_iters: int = 64
    # cosine learning-rate decay over ``total_steps`` (0 = constant lr)
    total_steps: int = 0


class InpaintGANTrainer:
    """Masked-residual inpainting GAN. ``generator`` and ``discriminator``
    are the networks to copy (default :class:`InpaintUNet` and
    :class:`PatchDiscriminator`); :meth:`init` draws their weights."""

    def __init__(self, cfg: InpaintTrainConfig = InpaintTrainConfig(),
                 generator: Optional[nn.Module] = None,
                 discriminator: Optional[nn.Module] = None, device="cuda"):
        self.cfg = cfg
        self.gen = generator or InpaintUNet()
        self.disc = discriminator or PatchDiscriminator()
        self.device = torch.device(device)
        self._round = _rounder(cfg.compute_dtype)

    def optimizers(self, g: nn.Module, d: nn.Module, step: int = 0) -> GANState:
        """A state of ``g`` and ``d`` with fresh optimisers (and schedules
        positioned at ``step``)."""
        cfg = self.cfg
        g_opt = adam(g.parameters(), self.device, lr=cfg.lr_g,
                     betas=(0.5, 0.999))
        d_opt = adam(d.parameters(), self.device, lr=cfg.lr_d,
                     betas=(0.5, 0.999))
        scheds = (None, None)
        if cfg.total_steps > 0:
            factor = cosine_decay(cfg.total_steps, 0.02)
            scheds = (_schedule(g_opt, factor, step),
                      _schedule(d_opt, factor, step))
        return GANState(g, d, g_opt, d_opt, step, *scheds)

    def init(self, sample=None, rng: Optional[torch.Generator] = None
             ) -> GANState:
        """Weights drawn from ``rng`` (a CPU generator; by default one
        seeded with 0), generator first. ``sample`` is accepted for the
        reference's signature; the networks know their shapes."""
        if rng is None:
            rng = torch.Generator().manual_seed(0)
        g = _fresh(self.gen, rng, self.device)
        d = _fresh(self.disc, rng, self.device)
        return self.optimizers(g, d)

    def train_step(self, state: GANState, images,
                   rng: Optional[torch.Generator]) -> Tuple[GANState, dict]:
        """One step on (B, H, W, 3) ``images`` with hole masks drawn from
        ``rng``. Trains ``state``'s networks in place; returns the state
        with its step advanced, and the losses (0-d tensors). In a
        data-parallel step each rank draws the whole batch's masks and
        keeps its shard's."""
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        b, h, w, _ = images.shape
        group = DATA_GROUP.get()
        n, r = ((1, 0) if group is None
                else (dist.get_world_size(group), dist.get_rank(group)))
        mask = random_hole_masks(rng, (b * n, h, w), self.cfg.mask_seeds,
                                 self.cfg.mask_steps, device=self.device)
        return self._step(state, images, mask[r * b:(r + 1) * b])

    def _step(self, state: GANState, images: torch.Tensor,
              mask: torch.Tensor) -> Tuple[GANState, dict]:
        """One step with the given (B, H, W, 1) hole ``mask``: D on the old
        G's output, then G through the updated D."""
        cfg = self.cfg
        rnd = self._round
        images = images.to(self.device)
        mask = mask.to(self.device)
        g, d = state.g, state.d
        inp = self._condition(images, mask)

        with torch.no_grad():
            fake = g(rnd(inp))
        d_loss = hinge_d_loss(d(rnd(images)), d(rnd(fake)))
        apply_gradients(state.d_opt, list(d.parameters()), d_loss)

        fake = g(rnd(inp))
        rec, parts = residual_inpaint_loss(fake, images, mask, cfg.w_grad,
                                           cfg.w_ring)
        gan = hinge_g_loss(d(rnd(fake)))
        g_loss = rec + cfg.w_gan * gan
        apply_gradients(state.g_opt, list(g.parameters()), g_loss)
        for sched in (state.g_sched, state.d_sched):
            if sched is not None:
                sched.step()
        metrics = {"d_loss": d_loss, "g_loss": g_loss, **parts, "gan": gan,
                   "rec": rec}
        return state._replace(step=state.step + 1), {
            k: v.detach() for k, v in metrics.items()}

    def _condition(self, images: torch.Tensor, mask: torch.Tensor
                   ) -> torch.Tensor:
        """(B, H, W, 3 + 1) generator input: the (pre)filled hole and the
        mask plane."""
        if self.cfg.prefill_condition:
            filled = masked_jacobi_fill_batch(images, mask[..., 0],
                                              self.cfg.prefill_iters)
        else:
            filled = images * (1 - mask)
        return torch.cat([filled, mask], dim=-1)

    def infer(self, state: GANState, images, mask, ensemble: bool = False):
        """The generator's output on ``images`` with ``mask`` (float32
        inputs). ``ensemble`` averages the four axis-flip variants."""
        images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        mask = torch.as_tensor(mask, dtype=torch.float32).to(self.device)
        g = state.g
        with torch.no_grad():
            if not ensemble:
                return g(self._condition(images, mask))
            out = None
            for fy in (False, True):
                for fx in (False, True):
                    dims = [a for a, f in ((1, fy), (2, fx)) if f]
                    im = images.flip(dims) if dims else images
                    mk = mask.flip(dims) if dims else mask
                    o = g(self._condition(im, mk))
                    o = o.flip(dims) if dims else o
                    out = o if out is None else out + o
            return out / 4.0


@dataclasses.dataclass(frozen=True)
class SRTrainConfig:
    lr: float = 2e-4
    lr_d: float = 1e-4
    w_gan: float = 0.003
    warmup_steps: int = 500
    factor: int = 4
    compute_dtype: str = "bfloat16"


class SRGANTrainer:
    """4x SR: MixGE warm-up, then GAN fine-tuning."""

    def __init__(self, cfg: SRTrainConfig = SRTrainConfig(),
                 generator: Optional[nn.Module] = None,
                 discriminator: Optional[nn.Module] = None, device="cuda"):
        self.cfg = cfg
        self.gen = generator or SRUNet()
        self.disc = discriminator or PatchDiscriminator(widths=(64, 128, 256))
        self.device = torch.device(device)
        self._round = _rounder(cfg.compute_dtype)

    def optimizers(self, g: nn.Module, d: nn.Module, step: int = 0) -> GANState:
        g_opt = adam(g.parameters(), self.device, lr=self.cfg.lr)
        d_opt = adam(d.parameters(), self.device, lr=self.cfg.lr_d)
        return GANState(g, d, g_opt, d_opt, step)

    def init(self, lr_sample=None, rng: Optional[torch.Generator] = None
             ) -> GANState:
        if rng is None:
            rng = torch.Generator().manual_seed(0)
        g = _fresh(self.gen, rng, self.device)
        d = _fresh(self.disc, rng, self.device)
        return self.optimizers(g, d)

    def train_step(self, state: GANState, lr_batch, hr_batch
                   ) -> Tuple[GANState, dict]:
        cfg = self.cfg
        rnd = self._round
        dev = self.device
        lr_batch = torch.as_tensor(lr_batch, dtype=torch.float32).to(dev)
        hr_batch = torch.as_tensor(hr_batch, dtype=torch.float32).to(dev)
        up = bicubic_upsample(lr_batch, cfg.factor)
        gan_on = 1.0 if state.step >= cfg.warmup_steps else 0.0
        g, d = state.g, state.d
        g_params = list(g.parameters())
        d_params = list(d.parameters())

        with torch.no_grad():
            fake = g(rnd(up))
        d_loss = gan_on * hinge_d_loss(d(rnd(hr_batch)), d(rnd(fake)))
        apply_gradients(state.d_opt, d_params, d_loss)

        sr = g(rnd(up))
        rec = mixge_loss(sr, hr_batch)
        gan = hinge_g_loss(d(rnd(sr)))
        g_loss = rec + cfg.w_gan * gan_on * gan
        apply_gradients(state.g_opt, g_params, g_loss)
        metrics = {"d_loss": d_loss, "g_loss": g_loss, "rec": rec, "gan": gan}
        return state._replace(step=state.step + 1), {
            k: v.detach() for k, v in metrics.items()}

    def infer(self, state: GANState, lr_batch) -> torch.Tensor:
        lr_batch = torch.as_tensor(lr_batch, dtype=torch.float32).to(self.device)
        with torch.no_grad():
            return state.g(bicubic_upsample(lr_batch, self.cfg.factor))


def _batched(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim > 0


def data_parallel_step(step_fn: Callable, mesh, data_axis: str = "data"
                       ) -> Callable:
    """Run a trainer's step data-parallel over ``mesh``'s ``data_axis``,
    called as the step is: ``wrapped(state, *args)``. It takes the port's
    trainer steps, :meth:`InpaintGANTrainer.train_step` and ``_step``,
    :meth:`SRGANTrainer.train_step`, :meth:`DetectorTrainer.train_step`
    and :meth:`OBBDetectorTrainer.train_step` (a detector step is
    ``wrapped(net, opt, images, boxes, valid)``); any other callable
    raises ``TypeError``, since a step that skips
    :func:`apply_gradients` would not average its gradients.

    The batch size is the leading axis of the first tensor or array after
    the state (the image batch) and must divide by the group's size. Each
    rank takes its equal shard of every tensor or array argument whose
    leading axis has that size (images, masks, boxes and their (B, K)
    validity); networks, optimisers, generators and scalars go whole to
    every rank. Every gradient is averaged over the group before each
    optimiser step (:func:`apply_gradients`), and every loss that sums
    over the batch divides by the whole batch's count
    (:func:`pcmi_tpu_torch.models.losses.batch_normaliser`: the hole
    pixels, the detectors' positive centres and valid boxes), the rest
    being means over equal shards. So each rank takes the whole batch's
    step, as GSPMD gives it to the reference's wrapper, up to the order
    of the sums. The metrics, the last element of what the step returns,
    are averaged over the group; the other elements are passed through.
    The state (networks and optimisers, stepped in place) must start
    equal on every rank."""
    # detector imports this module
    from pcmi_tpu_torch.models.detector import (
        DetectorTrainer, OBBDetectorTrainer)

    steps = ((InpaintGANTrainer, "train_step"), (InpaintGANTrainer, "_step"),
             (SRGANTrainer, "train_step"), (DetectorTrainer, "train_step"),
             (OBBDetectorTrainer, "train_step"))
    owner = getattr(step_fn, "__self__", None)
    name = getattr(step_fn, "__name__", None)
    if not any(isinstance(owner, cls) and name == fn for cls, fn in steps):
        raise TypeError("data_parallel_step takes " + ", ".join(
            f"{cls.__name__}.{fn}" for cls, fn in steps)
            + f", not {step_fn!r}")
    dim = mesh.mesh_dim_names.index(data_axis)
    group = mesh.get_group(dim)
    n, r = mesh.size(dim), mesh.get_local_rank(dim)

    def wrapped(state, *args):
        sizes = [a.shape[0] for a in args if _batched(a)]
        if not sizes or sizes[0] % n:
            raise ValueError(f"data_parallel_step: the image batch "
                             f"({sizes[:1]}) does not divide over {n} ranks")
        b, per = sizes[0], sizes[0] // n

        def place(x):
            if _batched(x) and x.shape[0] == b:
                return x[r * per:(r + 1) * per]
            return x

        token = DATA_GROUP.set(group)
        try:
            *rest, metrics = step_fn(state, *(place(a) for a in args))
        finally:
            DATA_GROUP.reset(token)
        names = sorted(metrics)
        vec = torch.stack([metrics[k].float() for k in names])
        dist.all_reduce(vec, group=group)
        vec /= n
        return (*rest, dict(zip(names, vec.unbind(0))))

    return wrapped


def make_sr_pairs(images: torch.Tensor, factor: int = 4
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(LR, HR) training pairs by box-downsampling (B, H, W, C) HR crops."""
    b, h, w, c = images.shape
    hh = (h // factor) * factor
    ww = (w // factor) * factor
    hr = images[:, :hh, :ww, :]
    lr = hr.reshape(b, hh // factor, factor, ww // factor, factor,
                    c).mean((2, 4))
    return lr, hr


def _leaves(state) -> list:
    """The leaves of a trainer state, depth first through its tuples."""
    if isinstance(state, tuple):
        return [leaf for part in state for leaf in _leaves(part)]
    return [state]


def _rebuild(template, leaves):
    """``template``'s tuples around the next leaves of the ``leaves``
    iterator."""
    if not isinstance(template, tuple):
        return next(leaves)
    parts = [_rebuild(t, leaves) for t in template]
    if hasattr(template, "_fields"):   # a NamedTuple such as GANState
        return type(template)(*parts)
    return tuple(parts)


_KINDS = ((nn.Module, "network"), (torch.optim.Optimizer, "optimizer"),
          (LambdaLR, "schedule"), ((int, type(None)), "value"))


def _kind(leaf) -> str:
    for cls, kind in _KINDS:
        if isinstance(leaf, cls):
            return kind
    raise TypeError(f"a checkpoint holds networks, optimisers, LambdaLR "
                    f"schedules, ints and None, not {type(leaf).__name__}")


def save_checkpoint(path: str, state, step: Optional[int] = None) -> None:
    """Any state a trainer of the port holds, in one ``torch.save`` file: a
    :class:`GANState`, a detector trainer's ``(net, opt)``, a bare network
    (the diffusion engine's, DIP's) or a tuple of these. Networks and
    optimisers go in as their ``state_dict``s, a ``LambdaLR`` as its
    count, ints (``GANState.step``) as they are. ``step`` is accepted for
    the reference's signature, which passes it to Orbax unused."""
    leaves = _leaves(state)
    kinds = [_kind(leaf) for leaf in leaves]
    torch.save({"kinds": kinds, "leaves": [
        leaf.state_dict() if kind in ("network", "optimizer")
        else leaf.last_epoch if kind == "schedule" else leaf
        for leaf, kind in zip(leaves, kinds)]}, path)


def restore_checkpoint(path: str, template):
    """A new state shaped like ``template`` on its device, holding the
    checkpoint's weights, optimiser moments and counts, schedule counts and
    ints: copies of its networks, its optimisers' class and settings over
    the copies' parameters, its schedules' factors over the new
    optimisers. ``template`` is not changed. The file is read with
    ``weights_only=True`` and must hold a state of ``template``'s shape."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    old = _leaves(template)
    kinds = [_kind(leaf) for leaf in old]
    if kinds != ck["kinds"]:
        raise ValueError(f"a checkpoint of {ck['kinds']} for a template of "
                         f"{kinds}")
    saved = ck["leaves"]
    new = list(saved)   # the values as they are
    params, opts = {}, {}
    for i, leaf in enumerate(old):
        if kinds[i] == "network":
            new[i] = copy.deepcopy(leaf)
            new[i].load_state_dict(saved[i])
            params.update(zip(map(id, leaf.parameters()), new[i].parameters()))
    for i, leaf in enumerate(old):
        if kinds[i] == "optimizer":
            try:
                groups = [{"params": [params[id(p)] for p in g["params"]]}
                          for g in leaf.param_groups]
            except KeyError:
                raise ValueError("an optimiser's parameters must belong to a "
                                 "network of the state") from None
            new[i] = type(leaf)(groups, **leaf.defaults)
            new[i].load_state_dict(saved[i])
            opts[id(leaf)] = new[i]
    for i, leaf in enumerate(old):
        if kinds[i] == "schedule":
            new[i] = _schedule(opts[id(leaf.optimizer)], leaf.lr_lambdas,
                               saved[i])
    return _rebuild(template, iter(new))
