"""Synthetic WV3-like stereo scenes with exact ground truth (port of
``pcmi_tpu/geometry/synthetic.py``).

Randomness comes from ``numpy.random.Generator(seed)`` in place of
``jax.random``, so a scene is a different draw from the reference's for the
same seed; rendering, cameras and RPC wrappers follow the reference. A
scene is deterministic for its seed. Scenes are built on the CPU in
float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pcmi_tpu_torch.geometry.affine import (
    M_PER_DEG_LAT, M_PER_DEG_LON_EQ, AffineCamera, LocalFrame)
from pcmi_tpu_torch.geometry.pairs import view_vector_np as view_vector
from pcmi_tpu_torch.geometry.rpc import RPCCamera, make_affine_rpc
from pcmi_tpu_torch.ops.warp import map_coordinates

TARGET_LAT = -34.490278
TARGET_LON = -58.584444


def make_satellite_camera(incidence_deg: float, azimuth_deg: float,
                          gsd: float = 0.5, offset=(0.0, 0.0)) -> AffineCamera:
    """Orthographic affine camera looking along the view vector, scaled to
    ``gsd`` metres per pixel."""
    v = view_vector(incidence_deg, azimuth_deg)
    up = np.array([0.0, 0.0, 1.0])
    e1 = np.cross(up, v)
    if np.linalg.norm(e1) < 1e-8:
        e1 = np.array([1.0, 0.0, 0.0])
    e1 = e1 / np.linalg.norm(e1)
    e2 = np.cross(v, e1)
    A = np.stack([e1, e2]) / gsd
    return AffineCamera(
        A=torch.from_numpy(A.astype(np.float32)),
        b=torch.from_numpy(np.asarray(offset, np.float64).astype(np.float32)))


def rpc_from_affine_camera(cam: AffineCamera, frame: LocalFrame, img_shape,
                           h_range=(0.0, 50.0),
                           aoi_half_deg=0.005) -> RPCCamera:
    """Exact RPC00B wrapper of an affine camera (denominators 1)."""
    A = cam.A.double().numpy()
    b = cam.b.double().numpy()
    kx = M_PER_DEG_LON_EQ * np.cos(np.radians(frame.lat0))
    ky = M_PER_DEG_LAT
    Ad = A @ np.diag([kx, ky, 1.0])
    offs = dict(
        LONG_OFF=frame.lon0, LAT_OFF=frame.lat0,
        HEIGHT_OFF=0.5 * (h_range[0] + h_range[1]),
        LONG_SCALE=aoi_half_deg, LAT_SCALE=aoi_half_deg,
        HEIGHT_SCALE=max(1.0, 0.5 * (h_range[1] - h_range[0])),
        SAMP_OFF=img_shape[1] / 2, LINE_OFF=img_shape[0] / 2,
        SAMP_SCALE=img_shape[1] / 2, LINE_SCALE=img_shape[0] / 2,
    )
    out = []
    for i, (pix_off, pix_scale) in enumerate(
            [(offs["SAMP_OFF"], offs["SAMP_SCALE"]),
             (offs["LINE_OFF"], offs["LINE_SCALE"])]):
        const = (Ad[i, 2] * offs["HEIGHT_OFF"] + b[i] - pix_off) / pix_scale
        c_lon = Ad[i, 0] * offs["LONG_SCALE"] / pix_scale
        c_lat = Ad[i, 1] * offs["LAT_SCALE"] / pix_scale
        c_h = Ad[i, 2] * offs["HEIGHT_SCALE"] / pix_scale
        out.append(np.array([const, c_lon, c_lat, c_h], np.float64))
    return make_affine_rpc(out[0], out[1], offs)


@dataclass
class SyntheticScene:
    """A rendered multi-view scene with exact truth (float32 tensors)."""

    images: list            # (H, W) per view, radiometrically varied
    heights: list           # (H, W) ground-truth surface height per view (m)
    cameras: list           # AffineCamera per view
    rpcs: list              # exact RPCCamera per view
    frame: LocalFrame
    terrain: torch.Tensor   # (Hg, Wg) height field (m)
    texture: torch.Tensor   # (Hg, Wg) ortho reflectance
    ground_gsd: float
    ground_origin: tuple    # local (x, y) of terrain[0, 0]
    h_range: tuple


def _smooth_noise(rng: np.random.Generator, shape, scales=(4, 16, 64),
                  amps=(1.0, 0.5, 0.25)) -> torch.Tensor:
    out = torch.zeros(shape, dtype=torch.float32)
    for s, a in zip(scales, amps):
        low = torch.from_numpy(rng.standard_normal(
            (shape[0] // s + 2, shape[1] // s + 2)).astype(np.float32))
        ys = torch.linspace(0, low.shape[0] - 2, shape[0])
        xs = torch.linspace(0, low.shape[1] - 2, shape[1])
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        out = out + a * map_coordinates(low, gy, gx)
    return out


def make_terrain(rng: np.random.Generator, shape=(768, 768), gsd=0.5,
                 h_range=(0.0, 50.0), n_buildings=24, terrain_fraction=0.4,
                 building_size_px=(8, 48), building_h_m=None,
                 base_scales=(96, 192)) -> torch.Tensor:
    """Smooth relief plus flat-roofed boxy buildings (height field, m)."""
    del gsd  # the relief is in grid cells, as in the reference
    base = _smooth_noise(rng, shape, scales=base_scales, amps=(1.0, 1.0))
    base = base - base.min()
    base = base / torch.clamp(base.max(), min=1e-6)
    lo, hi = h_range
    terrain = (lo + base * (hi - lo) * terrain_fraction).numpy().copy()
    ground = terrain.copy()

    hg, wg = shape
    ys, xs = np.mgrid[0:hg, 0:wg].astype(np.float32)
    centers = rng.uniform(0.1, 0.9, (n_buildings, 2)).astype(np.float32)
    sizes = rng.uniform(0.2, 1.0, (n_buildings, 3)).astype(np.float32)
    s_lo, s_hi = building_size_px
    for i in range(n_buildings):
        cy = centers[i, 0] * hg
        cx = centers[i, 1] * wg
        sy = s_lo + sizes[i, 0] * (s_hi - s_lo)
        sx = s_lo + sizes[i, 1] * (s_hi - s_lo)
        inside = (np.abs(ys - cy) < sy) & (np.abs(xs - cx) < sx)
        if building_h_m is None:
            bh = lo + (hi - lo) * (0.3 + 0.6 * sizes[i, 2])
        else:
            g = ground[int(cy), int(cx)]
            bh = g + building_h_m[0] + sizes[i, 2] * (
                building_h_m[1] - building_h_m[0])
        terrain[inside] = np.maximum(terrain[inside], bh)
    return torch.from_numpy(terrain)


def make_texture(rng: np.random.Generator, shape=(768, 768), scales=(2, 8, 32),
                 amps=(1.0, 0.8, 0.6), contrast: float = 1.0) -> torch.Tensor:
    """Matchable ortho texture in [0, 1]."""
    tex = _smooth_noise(rng, shape, scales=scales, amps=amps)
    tex = tex - tex.min()
    tex = tex / torch.clamp(tex.max(), min=1e-6)
    return 0.5 + contrast * (tex - 0.5)


def render_view(cam: AffineCamera, terrain: torch.Tensor,
                texture: torch.Tensor, ground_origin, gsd: float, out_shape,
                iters: int = 12):
    """Render terrain/texture through an affine camera by per-pixel
    fixed-point ray/terrain intersection. Returns (image, gt_height)."""
    dev = terrain.device
    A = cam.A.to(dev)
    b = cam.b.to(dev)
    A2inv = torch.linalg.inv(A[:, :2])
    az = A[:, 2]
    h, w = out_shape
    py = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    pix = torch.stack([px, py], dim=-1)
    ox, oy = ground_origin

    def ground_xy(z):
        rhs = pix - b - az * z[..., None]
        # elementwise 2x2 solve, as the reference writes it
        x = rhs[..., 0] * A2inv[0, 0] + rhs[..., 1] * A2inv[0, 1]
        y = rhs[..., 0] * A2inv[1, 0] + rhs[..., 1] * A2inv[1, 1]
        return x, y

    def grid(x, y):
        return (y - oy) / gsd, (x - ox) / gsd

    z = torch.full((h, w), float(terrain.mean()), device=dev)
    for _ in range(iters):
        z = map_coordinates(terrain, *grid(*ground_xy(z)), fill=float("nan"))
    img = map_coordinates(texture, *grid(*ground_xy(z)), fill=-1.0)
    return img, z


def make_stereo_scene(seed: int = 0, ground_shape=(768, 768), gsd: float = 0.5,
                      h_range=(0.0, 50.0),
                      views=((12.0, 90.0), (22.0, 260.0)),
                      out_shape=(640, 640), radiometric_jitter: float = 0.15,
                      origin_lonlat=(TARGET_LON, TARGET_LAT),
                      terrain_kwargs: dict | None = None,
                      texture_kwargs: dict | None = None,
                      noise_sigma: float = 0.01) -> SyntheticScene:
    """Full multi-view scene; ``views`` are (incidence, azimuth) degrees."""
    rng = np.random.default_rng(seed)
    terrain = make_terrain(rng, ground_shape, gsd, h_range,
                           **(terrain_kwargs or {}))
    texture = make_texture(rng, ground_shape, **(texture_kwargs or {}))
    hg, wg = ground_shape
    origin = (-0.5 * wg * gsd, -0.5 * hg * gsd)
    frame = LocalFrame(lon0=origin_lonlat[0], lat0=origin_lonlat[1])

    images, heights, cams, rpcs = [], [], [], []
    for inc, az in views:
        cam = make_satellite_camera(inc, az, gsd,
                                    offset=(out_shape[1] / 2, out_shape[0] / 2))
        img, z = render_view(cam, terrain, texture, origin, gsd, out_shape)
        gain = 1.0 + radiometric_jitter * float(rng.standard_normal())
        offset = 0.1 * radiometric_jitter * float(rng.standard_normal())
        noise = noise_sigma * torch.from_numpy(
            rng.standard_normal(img.shape).astype(np.float32))
        jimg = torch.where(img >= 0, (img * gain + offset + noise).clamp(0, 4),
                           torch.full_like(img, -1.0))
        images.append(jimg)
        heights.append(z)
        cams.append(cam)
        rpcs.append(rpc_from_affine_camera(cam, frame, out_shape, h_range))
    return SyntheticScene(
        images=images, heights=heights, cameras=cams, rpcs=rpcs, frame=frame,
        terrain=terrain, texture=texture, ground_gsd=gsd,
        ground_origin=origin, h_range=h_range)


def aoi_lonlat_ranges(scene: SyntheticScene):
    """Lon/lat bounds of the scene's ground extent (float32, as the
    reference computes them)."""
    ox, oy = scene.ground_origin
    hg, wg = scene.terrain.shape
    xs = torch.tensor([ox, ox + wg * scene.ground_gsd], dtype=torch.float32)
    ys = torch.tensor([oy, oy + hg * scene.ground_gsd], dtype=torch.float32)
    lon, lat, _ = scene.frame.to_geodetic(xs, ys, 0.0)
    return ((float(lon.min()), float(lon.max())),
            (float(lat.min()), float(lat.max())))


# Scene families: each stresses one failure mode of the dense matcher. All
# share ``out_shape``, ``h_range`` and ``views``, so one stereo config
# serves the whole sweep.
SCENE_FAMILIES: dict = {
    # default mix of relief + mid-rise buildings
    "baseline": {},
    # discontinuity-dense built-up core: tall buildings
    "urban": dict(terrain_kwargs=dict(
        n_buildings=40, terrain_fraction=0.25,
        building_size_px=(14, 56), building_h_m=(8.0, 24.0))),
    # steep smooth topography: high-gradient slopes, no steps
    "steep": dict(terrain_kwargs=dict(
        terrain_fraction=1.0, n_buildings=6, base_scales=(48, 96))),
    # bland, low-contrast surfaces (fields / water margins)
    "lowtex": dict(texture_kwargs=dict(
        scales=(8, 32, 64), amps=(0.6, 1.0, 0.8), contrast=0.35)),
    # cross-date radiometric mismatch: strong per-view gain/offset drift
    "crossdate": dict(radiometric_jitter=0.45, noise_sigma=0.02),
    # sensor noise at 4x the default
    "noisy": dict(noise_sigma=0.04),
}


def make_family_scene(family: str, seed: int = 11, out_shape=(384, 384),
                      ground_shape=(512, 512), h_range=(0.0, 40.0),
                      views=((12.0, 90.0), (22.0, 260.0)),
                      **overrides) -> SyntheticScene:
    """Build one scene of a named family (see :data:`SCENE_FAMILIES`)."""
    kw = dict(SCENE_FAMILIES[family])
    kw.update(overrides)
    return make_stereo_scene(seed=seed, out_shape=out_shape,
                             ground_shape=ground_shape, h_range=h_range,
                             views=views, **kw)
