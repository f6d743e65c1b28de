"""pcmi_tpu_torch: the PyTorch + CUDA port of pcmi_tpu.

It mirrors ``pcmi_tpu``'s module paths. Plain tensor code is PyTorch,
executed eagerly; the matcher's kernels are hand-written CUDA C++ for
Hopper (``csrc/``, see :mod:`pcmi_tpu_torch.ops.stereo.kernels`). The
device comes from the tensors passed in or from
``HeightMapPipeline(cfg, device=...)``, whose entry points default to
``"cuda"``: the CPU runs only where a caller asks for it (as the tests do),
nothing probes for a card, and a CUDA tensor never falls back to the CPU.

Configuration objects are the port's own copy of the reference's
dataclasses (:mod:`pcmi_tpu_torch.config`); nothing of ``pcmi_tpu`` is
imported.

Float32 products on the card run in full float32: TF32 is switched off for
matrix products and for cuDNN convolutions, because triangulation and the
plane fit lose metres of height in TF32 (the reference runs them at
``precision=HIGHEST``).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
