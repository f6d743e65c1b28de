"""The benchmark's input generator: a synthetic multi-date scene with exact
truth, made from the run's seed (a frozen copy of the port's
``geometry/synthetic.make_stereo_scene``).

The terrain and texture draws come from ``numpy.random.default_rng(seed)``
on the host; the views are rendered on ``device`` (bilinear ray/terrain
intersection through affine cameras) and handed back as host tensors, as
a loader hands images over. Each view's camera is an exact RPC00B model,
given as a GDAL-style coefficient dict that both the program and the
reference build their own camera objects from. Every seed gives the same
sizes; only the scene's content changes.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference.geometry.affine import (
    M_PER_DEG_LAT, M_PER_DEG_LON_EQ, AffineCamera, LocalFrame)
from perfbench.reference.geometry.pairs import view_vector_np
from perfbench.reference.ops.warp import map_coordinates

TARGET_LAT = -34.490278
TARGET_LON = -58.584444


@dataclass
class Scene:
    images: list          # (H, W) float32 host tensors, -1 outside the view
    rpcs: list            # GDAL-style RPC00B dicts, one per view
    views: list           # (incidence, azimuth) degrees per view
    dates: list           # acquisition day per view
    terrain: np.ndarray   # (Hg, Wg) true height field (m)
    ground_gsd: float
    ground_origin: tuple  # local (x, y) of terrain[0, 0]
    lon_range: tuple
    lat_range: tuple

    def pairs(self):
        """Every pair of views, in enumeration order."""
        return list(itertools.combinations(range(len(self.images)), 2))


def _camera(inc: float, az: float, gsd: float, offset) -> AffineCamera:
    v = view_vector_np(inc, az)
    e1 = np.cross(np.array([0.0, 0.0, 1.0]), v)
    if np.linalg.norm(e1) < 1e-8:
        e1 = np.array([1.0, 0.0, 0.0])
    e1 = e1 / np.linalg.norm(e1)
    e2 = np.cross(v, e1)
    A = np.stack([e1, e2]) / gsd
    return AffineCamera(
        A=torch.from_numpy(A.astype(np.float32)),
        b=torch.from_numpy(np.asarray(offset, np.float64).astype(np.float32)))


def rpc_dict(cam: AffineCamera, frame: LocalFrame, img_shape, h_range,
             aoi_half_deg: float = 0.005) -> dict:
    """Exact RPC00B coefficients of an affine camera (denominators 1)."""
    A = cam.A.double().numpy()
    b = cam.b.double().numpy()
    kx = M_PER_DEG_LON_EQ * np.cos(np.radians(frame.lat0))
    Ad = A @ np.diag([kx, M_PER_DEG_LAT, 1.0])
    offs = dict(
        LONG_OFF=frame.lon0, LAT_OFF=frame.lat0,
        HEIGHT_OFF=0.5 * (h_range[0] + h_range[1]),
        LONG_SCALE=aoi_half_deg, LAT_SCALE=aoi_half_deg,
        HEIGHT_SCALE=max(1.0, 0.5 * (h_range[1] - h_range[0])),
        SAMP_OFF=img_shape[1] / 2, LINE_OFF=img_shape[0] / 2,
        SAMP_SCALE=img_shape[1] / 2, LINE_SCALE=img_shape[0] / 2)
    nums = []
    for i, key in ((0, "SAMP"), (1, "LINE")):
        off, scale = offs[f"{key}_OFF"], offs[f"{key}_SCALE"]
        num = np.zeros(20, np.float32)
        num[:4] = [(Ad[i, 2] * offs["HEIGHT_OFF"] + b[i] - off) / scale,
                   Ad[i, 0] * offs["LONG_SCALE"] / scale,
                   Ad[i, 1] * offs["LAT_SCALE"] / scale,
                   Ad[i, 2] * offs["HEIGHT_SCALE"] / scale]
        nums.append(num)
    den = np.zeros(20, np.float32)
    den[0] = 1.0
    return dict(offs, SAMP_NUM_COEFF=nums[0], LINE_NUM_COEFF=nums[1],
                SAMP_DEN_COEFF=den, LINE_DEN_COEFF=den.copy())


def _smooth_noise(rng, shape, scales, amps, device) -> torch.Tensor:
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    for s, a in zip(scales, amps):
        low = torch.from_numpy(rng.standard_normal(
            (shape[0] // s + 2, shape[1] // s + 2)).astype(np.float32)
        ).to(device)
        ys = torch.linspace(0, low.shape[0] - 2, shape[0], device=device)
        xs = torch.linspace(0, low.shape[1] - 2, shape[1], device=device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        out = out + a * map_coordinates(low, gy, gx)
    return out


def _terrain(rng, shape, h_range, device, n_buildings=24,
             terrain_fraction=0.4, building_size_px=(8, 48),
             building_h_m=None, base_scales=(96, 192)) -> torch.Tensor:
    """Smooth relief plus flat-roofed boxy buildings (height field, m)."""
    base = _smooth_noise(rng, shape, base_scales, (1.0, 1.0), device)
    base = base - base.min()
    base = base / torch.clamp(base.max(), min=1e-6)
    lo, hi = h_range
    terrain = (lo + base * (hi - lo) * terrain_fraction).cpu().numpy().copy()
    ground = terrain.copy()
    hg, wg = shape
    ys, xs = np.mgrid[0:hg, 0:wg].astype(np.float32)
    centers = rng.uniform(0.1, 0.9, (n_buildings, 2)).astype(np.float32)
    sizes = rng.uniform(0.2, 1.0, (n_buildings, 3)).astype(np.float32)
    s_lo, s_hi = building_size_px
    for i in range(n_buildings):
        cy, cx = centers[i, 0] * hg, centers[i, 1] * wg
        sy = s_lo + sizes[i, 0] * (s_hi - s_lo)
        sx = s_lo + sizes[i, 1] * (s_hi - s_lo)
        inside = (np.abs(ys - cy) < sy) & (np.abs(xs - cx) < sx)
        if building_h_m is None:
            bh = lo + (hi - lo) * (0.3 + 0.6 * sizes[i, 2])
        else:
            bh = ground[int(cy), int(cx)] + building_h_m[0] + sizes[i, 2] * (
                building_h_m[1] - building_h_m[0])
        terrain[inside] = np.maximum(terrain[inside], bh)
    return torch.from_numpy(terrain).to(device)


def _texture(rng, shape, device, scales=(2, 8, 32), amps=(1.0, 0.8, 0.6),
             contrast: float = 1.0) -> torch.Tensor:
    tex = _smooth_noise(rng, shape, scales, amps, device)
    tex = tex - tex.min()
    tex = tex / torch.clamp(tex.max(), min=1e-6)
    return 0.5 + contrast * (tex - 0.5)


def _render(cam: AffineCamera, terrain, texture, origin, gsd, out_shape,
            iters: int = 12) -> torch.Tensor:
    """Per-pixel fixed-point ray/terrain intersection, then the texture."""
    dev = terrain.device
    A, b = cam.A.to(dev), cam.b.to(dev)
    A2inv = torch.linalg.inv(A[:, :2])
    az = A[:, 2]
    h, w = out_shape
    py = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    pix = torch.stack([px, py], dim=-1)
    ox, oy = origin

    def grid(z):
        rhs = pix - b - az * z[..., None]
        x = rhs[..., 0] * A2inv[0, 0] + rhs[..., 1] * A2inv[0, 1]
        y = rhs[..., 0] * A2inv[1, 0] + rhs[..., 1] * A2inv[1, 1]
        return (y - oy) / gsd, (x - ox) / gsd

    z = torch.full((h, w), float(terrain.mean()), device=dev)
    for _ in range(iters):
        z = map_coordinates(terrain, *grid(z), fill=float("nan"))
    return map_coordinates(texture, *grid(z), fill=-1.0)


def make_scene(spec: dict, seed: int, device="cpu") -> Scene:
    """The scene of a configuration's ``scene`` section for ``seed``."""
    rng = np.random.default_rng(seed)
    hg, wg = spec["ground_shape"]
    gsd = float(spec["gsd"])
    h_range = tuple(spec["h_range"])
    out_shape = (spec["crop_px"], spec["crop_px"])
    terrain = _terrain(rng, (hg, wg), h_range, device,
                       **{k: tuple(v) if isinstance(v, list) else v
                          for k, v in spec.get("terrain", {}).items()})
    texture = _texture(rng, (hg, wg), device)
    origin = (-0.5 * wg * gsd, -0.5 * hg * gsd)
    frame = LocalFrame(lon0=TARGET_LON, lat0=TARGET_LAT)
    jitter = float(spec.get("radiometric_jitter", 0.15))
    noise_sigma = float(spec.get("noise_sigma", 0.01))
    images, rpcs = [], []
    for inc, az in spec["views"]:
        cam = _camera(inc, az, gsd, (out_shape[1] / 2, out_shape[0] / 2))
        img = _render(cam, terrain, texture, origin, gsd, out_shape).cpu()
        gain = 1.0 + jitter * float(rng.standard_normal())
        offset = 0.1 * jitter * float(rng.standard_normal())
        noise = noise_sigma * torch.from_numpy(
            rng.standard_normal(img.shape).astype(np.float32))
        images.append(torch.where(
            img >= 0, (img * gain + offset + noise).clamp(0, 4),
            torch.full_like(img, -1.0)))
        rpcs.append(rpc_dict(cam, frame, out_shape, h_range))
    # the AOI's lon/lat bounds over the ground extent (float32)
    xs = torch.tensor([origin[0], origin[0] + wg * gsd], dtype=torch.float32)
    ys = torch.tensor([origin[1], origin[1] + hg * gsd], dtype=torch.float32)
    lon, lat, _ = frame.to_geodetic(xs, ys, 0.0)
    step = float(spec.get("date_step_days", 20.0))
    return Scene(
        images=images, rpcs=rpcs, views=[tuple(v) for v in spec["views"]],
        dates=[step * i for i in range(len(images))],
        terrain=terrain.cpu().numpy(), ground_gsd=gsd, ground_origin=origin,
        lon_range=(float(lon.min()), float(lon.max())),
        lat_range=(float(lat.min()), float(lat.max())))


def truth_at(scene: Scene, xyz: np.ndarray):
    """The true terrain height, bilinearly sampled at triangulated (x, y),
    and the in-bounds mask."""
    ox, oy = scene.ground_origin
    terr = scene.terrain
    gx = (xyz[..., 0] - ox) / scene.ground_gsd
    gy = (xyz[..., 1] - oy) / scene.ground_gsd
    gxc = np.clip(gx, 0, terr.shape[1] - 1)
    gyc = np.clip(gy, 0, terr.shape[0] - 1)
    x0 = np.floor(gxc).astype(int)
    y0 = np.floor(gyc).astype(int)
    x1 = np.clip(x0 + 1, 0, terr.shape[1] - 1)
    y1 = np.clip(y0 + 1, 0, terr.shape[0] - 1)
    tx, ty = gxc - x0, gyc - y0
    t = (terr[y0, x0] * (1 - ty) * (1 - tx) + terr[y0, x1] * (1 - ty) * tx
         + terr[y1, x0] * ty * (1 - tx) + terr[y1, x1] * ty * tx)
    inb = ((gx >= 0) & (gx < terr.shape[1] - 1)
           & (gy >= 0) & (gy < terr.shape[0] - 1))
    return t, inb


def cell_truth(scene: Scene, origin, cell: float, shape):
    """Cell-centre truth of a DSM grid and its in-bounds mask."""
    ny, nx = shape
    x0, y0 = origin
    gx = (x0 + (np.arange(nx) + 0.5) * cell - scene.ground_origin[0]) \
        / scene.ground_gsd
    gy = (y0 + (np.arange(ny) + 0.5) * cell - scene.ground_origin[1]) \
        / scene.ground_gsd
    gxm, gym = np.meshgrid(gx, gy)
    terr = scene.terrain
    inb = ((gxm >= 0) & (gxm < terr.shape[1] - 1)
           & (gym >= 0) & (gym < terr.shape[0] - 1))
    tt = terr[np.clip(gym.astype(int), 0, terr.shape[0] - 1),
              np.clip(gxm.astype(int), 0, terr.shape[1] - 1)]
    return tt, inb


def dsm_truth(scene: Scene, got: dict, what: str) -> str:
    """A DSM's height RMSE against the cell-centre truth and its filled
    share of the truth's cells, as a line of text."""
    tt, inb = cell_truth(scene, got["origin"], got["cell"], got["dsm"].shape)
    filled = np.isfinite(got["dsm"]) & inb
    rmse = float(np.sqrt(np.mean((got["dsm"][filled] - tt[filled]) ** 2))
                 ) if filled.any() else float("nan")
    return (f"truth {what}: rmse {rmse!r} m, filled "
            f"{float(filled.sum() / max(inb.sum(), 1))!r} of the cells")
