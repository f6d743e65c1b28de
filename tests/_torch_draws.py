"""The reference's own random draws for the port's scene renderers: what
``pcmi_tpu.models.detector.synthesize_obb_batch`` draws from a key, as
CPU tensors (``pcmi_tpu_torch.models.detector.render_obb_batch`` renders
them). Used by ``tests/test_torch_detector.py`` and by ``train_probe.py
export``."""

import jax
import numpy as np
import torch


def obb_draws(key, batch, size, max_objects=5, hard=True):
    """``synthesize_obb_batch``'s own draws from ``key``."""
    r = jax.random
    kb, kn, kc, ks, ka, kg, kd = r.split(key, 7)
    lo_l, hi_l = (11.0, 34.0) if hard else (16.0, 30.0)
    lo_b = 0.18 if hard else 0.25
    sh = (batch, max_objects)
    d = dict(gy=r.normal(kn, (batch, size // 8 + 2, size // 8 + 2, 1)),
             g2=r.normal(r.fold_in(kn, 1), (batch, size // 2, size // 2, 1)),
             n_obj=r.randint(kb, (batch,), 1, max_objects + 1),
             cy=r.uniform(kc, sh, minval=0.18, maxval=0.82) * size,
             cx=r.uniform(r.fold_in(kc, 1), sh, minval=0.18,
                          maxval=0.82) * size,
             length=r.uniform(ks, sh, minval=lo_l, maxval=hi_l))
    d["span"] = d["length"] * r.uniform(r.fold_in(ks, 1), sh, minval=0.7,
                                        maxval=0.95)
    d["theta"] = r.uniform(ka, sh, minval=-np.pi / 2, maxval=np.pi / 2)
    d["bright"] = r.uniform(kg, sh, minval=lo_b, maxval=0.45)
    if hard:
        nd = 4
        k1, k2, k3, k4, k5 = r.split(kd, 5)
        d["dy"] = r.uniform(k1, (batch, nd)) * size
        d["dx"] = r.uniform(r.fold_in(k1, 1), (batch, nd)) * size
        d["dl"] = r.uniform(k2, (batch, nd), minval=8.0, maxval=26.0)
        d["dw"] = d["dl"] * r.uniform(r.fold_in(k2, 1), (batch, nd),
                                      minval=0.3, maxval=0.6)
        d["dth"] = r.uniform(k3, (batch, nd), minval=-np.pi / 2,
                             maxval=np.pi / 2)
        d["dbr"] = r.uniform(k4, (batch, nd), minval=lo_b, maxval=0.45)
        d["round"] = r.bernoulli(k5, 0.4, (batch, nd))
        kr = r.fold_in(kd, 7)
        d["p0"] = r.uniform(kr, (batch, 2, 2)) * size
        d["ang"] = r.uniform(r.fold_in(kr, 1), (batch, 2), minval=0.0,
                             maxval=np.pi)
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
