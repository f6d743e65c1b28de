"""Headless command line of the port (port of ``pcmi_tpu/cli.py``):

    python -m pcmi_tpu_torch list
    python -m pcmi_tpu_torch run height-map --input scene.tif --output out/
    python -m pcmi_tpu_torch height-map --demo --output out/
    python -m pcmi_tpu_torch height-map --images DIR --kml AOI.kml
    python -m pcmi_tpu_torch fuse --demo --output out/
    python -m pcmi_tpu_torch stream --images DIR --kml AOI.kml

``run``, ``height-map``, ``fuse`` and ``stream`` run on ``--device``
(default ``cuda``: the hand-written CUDA kernels; ``--device cpu`` runs
their plain PyTorch versions), e.g.
``python -m pcmi_tpu_torch run stitching --input a.tif --input2 b.tif
--device cpu``. Config overrides use dotted keys:
``--set stereo.max_disp=128``; a value is read as JSON where it parses.
The reference's ``bench`` command is not part of the port yet.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

from pcmi_tpu_torch.config import PipelineConfig, from_flat_overrides
from pcmi_tpu_torch.io.raster import read_tiff, write_ply, write_tiff


def _load_image(path: str) -> np.ndarray:
    return np.asarray(read_tiff(path), np.float32)


def _save_layers(layers, outdir: str) -> list:
    from pcmi_tpu_torch.interface import as_numpy_layers

    os.makedirs(outdir, exist_ok=True)
    written = []
    for data, params, kind in as_numpy_layers(layers):
        # error-layer names embed exception text, which routinely
        # contains '/' and other path-hostile characters
        name = re.sub(r"[^A-Za-z0-9._-]+", "_",
                      str(params.get("name", kind)))[:128] or kind
        if kind in ("image", "labels") and data.ndim in (2, 3):
            path = os.path.join(outdir, f"{name}.tif")
            write_tiff(path, data.astype(np.float32))
        else:
            path = os.path.join(outdir, f"{name}.json")
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(data.tolist(), fh)
        written.append(path)
    return written


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        key, _, val = p.partition("=")
        try:
            out[key] = json.loads(val)
        except json.JSONDecodeError:
            out[key] = val
    return out


def _config(args) -> PipelineConfig:
    return from_flat_overrides(PipelineConfig(), _parse_overrides(args.set))


_DEMO_VIEWS = ((10.0, 80.0), (20.0, 250.0), (16.0, 170.0))


def _demo_scene(cfg):
    from pcmi_tpu_torch.geometry.synthetic import (
        aoi_lonlat_ranges, make_stereo_scene)

    scene = make_stereo_scene(
        seed=1, out_shape=(512, 512), ground_shape=(640, 640),
        h_range=cfg.rectify.height_range,
        views=_DEMO_VIEWS,
    )
    return scene, aoi_lonlat_ranges(scene)


def _load_stack(args, cfg):
    """The shared ``--images``/``--demo`` sources of height-map, fuse and
    stream: ``(images, rpcs, metas, lon_range, lat_range)``, or None
    after a usage or diagnostic message (the caller exits 2)."""
    from pcmi_tpu_torch.geometry.pairs import ImageMeta

    if args.images:
        if not args.kml:
            print("--images requires --kml AOI", file=sys.stderr)
            return None
        from pcmi_tpu_torch.pipelines.ingest import (
            discover_acquisitions, prepare_aoi_stack)

        acqs = discover_acquisitions(args.images)
        if not acqs:
            print(f"no usable acquisitions in {args.images}", file=sys.stderr)
            return None
        stack = prepare_aoi_stack(acqs, kml_path=args.kml)
        if len(stack[0]) < 2:
            print("fewer than two acquisitions intersect the AOI",
                  file=sys.stderr)
            return None
        return stack
    if args.demo:
        scene, (lon_r, lat_r) = _demo_scene(cfg)
        metas = [ImageMeta(i, inc, az, date=30.0 * i)
                 for i, (inc, az) in enumerate(_DEMO_VIEWS)]
        return scene.images, scene.rpcs, metas, lon_r, lat_r
    print("need --demo or --images DIR --kml FILE", file=sys.stderr)
    return None


def cmd_list(args) -> int:
    from pcmi_tpu_torch import registry

    for name in registry.available():
        print(name)
    fails = registry.failures()
    if fails:
        print("\nunavailable:", file=sys.stderr)
        for name, err in fails.items():
            print(f"  {name}: {err.splitlines()[-1]}", file=sys.stderr)
    return 0


def cmd_run(args) -> int:
    from pcmi_tpu_torch import registry

    try:
        plugin = registry.create(args.plugin, device=args.device)
    except KeyError as exc:
        print(exc.args[0], file=sys.stderr)
        return 2
    image = _load_image(args.input)
    kwargs = {}
    if args.input2:
        kwargs["image2"] = _load_image(args.input2)
    failed = False
    try:
        layers = plugin.run(image, **kwargs)
    except Exception as exc:  # the reference host's error layer
        layers = [(np.zeros((8, 8), np.float32),
                   {"name": f"ERROR {plugin.name}: {exc}"}, "image")]
        print(f"error: {exc}", file=sys.stderr)
        failed = True
    for path in _save_layers(layers, args.output):
        print(path)
    # a placeholder layer is not a product: the exit code says so
    return 1 if failed else 0


def cmd_height_map(args) -> int:
    """One pair: sources -> rectify -> disparity -> height.

    The best-convergence pair of ``--demo`` or of the acquisitions in
    ``--images`` (cropped to ``--kml``) runs on ``--device``. Products:
    the canvas-space height and disparity rasters, the point cloud
    (``cloud.ply``) and a georeferenced north-up DSM (``dsm.tif``); one
    JSON summary line on stdout.
    """
    from pcmi_tpu_torch.geometry.pairs import select_pairs, take_pairs
    from pcmi_tpu_torch.pipelines.height_map import (
        HeightMapPipeline, product_point_cloud)
    from pcmi_tpu_torch.pipelines.streaming import (
        dsm_finalize, dsm_update, empty_dsm)

    cfg = _config(args)
    stack = _load_stack(args, cfg)
    if stack is None:
        return 2
    images, rpcs, metas, lon_r, lat_r = stack
    cands = take_pairs(select_pairs(metas, cfg.pairs), 1)
    if not cands:  # no geometrically valid pair: the best-ranked one
        cands = select_pairs(metas, cfg.pairs)[:1]
    pair = cands[0]
    i, j = pair.i, pair.j

    pipe = HeightMapPipeline(cfg, device=args.device)
    geom = pipe.build_geometry(rpcs[i], rpcs[j], lon_r, lat_r,
                               tuple(images[i].shape), tuple(images[j].shape))
    product = pipe.process_pair(images[i], images[j], geom)
    os.makedirs(args.output, exist_ok=True)
    write_tiff(os.path.join(args.output, "height.tif"),
               product.height.cpu().numpy())
    write_tiff(os.path.join(args.output, "disparity.tif"),
               product.disparity.cpu().numpy())
    pts, w = product_point_cloud(product)
    keep = w > 0
    pts, wts = pts[keep], w[keep]
    pts_np = pts.cpu().numpy()
    write_ply(os.path.join(args.output, "cloud.ply"), pts_np, pts_np[:, 2])

    # the pair's points gridded to a georeferenced north-up DSM
    dsm_shape = None
    if len(pts_np):
        cell = 2.0
        x0 = float(np.floor(pts_np[:, 0].min()))
        y0 = float(np.floor(pts_np[:, 1].min()))
        nx = max(int(np.ceil((pts_np[:, 0].max() - x0) / cell)) + 1, 1)
        ny = max(int(np.ceil((pts_np[:, 1].max() - y0) / cell)) + 1, 1)
        acc = dsm_update(empty_dsm((ny, nx), pipe.device), pts[:, :2],
                         pts[:, 2], wts, (x0, y0), cell, (ny, nx),
                         robust_sigma=3.0)
        dsm, _ = dsm_finalize(acc)
        _write_north_up(os.path.join(args.output, "dsm.tif"), dsm,
                        (x0, y0), cell)
        dsm_shape = [ny, nx]

    print(json.dumps({
        "pair": [metas[i].name or str(i), metas[j].name or str(j)],
        "convergence_deg": round(pair.convergence_deg, 2),
        "canvas": list(geom.out_shape),
        "valid_fraction": float(product.valid.cpu().numpy().mean()),
        "points": len(pts_np),
        "dsm_shape": dsm_shape,
    }))
    return 0


def _write_north_up(path: str, img: np.ndarray, origin_min_xy,
                    cell: float) -> None:
    """Write a grid whose row 0 sits at min-y as a north-up GeoTIFF:
    rows flipped, the tiepoint at the max-y outer corner and a positive
    ScaleY (``Y = Y0 - row * ScaleY``, which GDAL and QGIS read as is)."""
    x0, y0 = origin_min_xy
    ny = img.shape[0]
    write_tiff(path, np.ascontiguousarray(img[::-1]),
               geo={"origin": (float(x0), float(y0) + ny * float(cell)),
                    "scale": (float(cell), float(cell))})


def cmd_fuse(args) -> int:
    """Multi-day fusion of the selected pairs on ``--device``: a north-up
    DSM and the fused cloud."""
    from pcmi_tpu_torch.pipelines.multiday import MultiDayFusion

    cfg = _config(args)
    stack = _load_stack(args, cfg)
    if stack is None:
        return 2
    images, rpcs, metas, lon_r, lat_r = stack
    fused = MultiDayFusion(cfg, device=args.device).run(
        images, rpcs, metas, lon_r, lat_r, points_per_pair=1 << 16,
        with_kmeans=True, grid_cell=2.0)
    os.makedirs(args.output, exist_ok=True)
    dsm = fused.dsm.cpu().numpy()
    _write_north_up(os.path.join(args.output, "dsm.tif"), dsm,
                    fused.grid_origin, fused.grid_cell)
    keep = fused.weights > 0
    pts = fused.points[keep].cpu().numpy()
    write_ply(os.path.join(args.output, "fused_cloud.ply"), pts, pts[:, 2])
    print(json.dumps({
        "dsm_shape": list(dsm.shape),
        "points": len(pts),
        "icp_rmse": [float(x) for x in fused.icp_rmse.cpu()],
    }))
    return 0


def _write_hillshade(path: str, dsm: np.ndarray, cell: float) -> None:
    """Shaded-relief PNG of a DSM (the at-a-glance product check)."""
    from pcmi_tpu_torch.utils.visualize import save_image

    z = np.nan_to_num(dsm, nan=float(np.nanmin(dsm) if np.isfinite(dsm).any() else 0))
    gy, gx = np.gradient(z, cell)
    az, alt = np.radians(315.0), np.radians(45.0)
    slope = np.arctan(np.hypot(gx, gy))
    aspect = np.arctan2(-gx, gy)
    shade = (np.sin(alt) * np.cos(slope)
             + np.cos(alt) * np.sin(slope) * np.cos(az - aspect))
    shade = np.where(np.isfinite(dsm), shade, np.nan)
    save_image(path, shade)


def cmd_stream(args) -> int:
    """The streaming whole-AOI pipeline on ``--device``: DSM, pairs per
    cell and a hillshade."""
    from pcmi_tpu_torch.pipelines.streaming import StreamingAOIPipeline

    cfg = _config(args)
    stack = _load_stack(args, cfg)
    if stack is None:
        return 2
    images, rpcs, metas, lon_r, lat_r = stack
    out = StreamingAOIPipeline(cfg, device=args.device).run(
        images, rpcs, metas, lon_r, lat_r, grid_cell=1.0)
    os.makedirs(args.output, exist_ok=True)
    _write_north_up(os.path.join(args.output, "dsm.tif"),
                    np.asarray(out["dsm"], np.float32),
                    out["origin"], out["cell"])
    _write_north_up(os.path.join(args.output, "n_pairs.tif"),
                    np.asarray(out["n_pairs_per_cell"], np.float32),
                    out["origin"], out["cell"])
    _write_hillshade(os.path.join(args.output, "hillshade.png"),
                     out["dsm"], out["cell"])
    print(json.dumps({
        "dsm_shape": list(out["dsm"].shape), "pairs": out["pairs"],
        "tiles": out["tiles"],
        "filled": float(np.isfinite(out["dsm"]).mean()),
    }))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="pcmi_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list available plugins")

    rp = sub.add_parser("run", help="run a plugin over a TIFF")
    rp.add_argument("plugin")
    rp.add_argument("--input", required=True)
    rp.add_argument("--input2")
    rp.add_argument("--output", default="out")
    rp.add_argument("--device", default="cuda",
                    help="torch device the plugin runs on (default: cuda)")

    for name in ("height-map", "fuse", "stream"):
        p = sub.add_parser(name)
        p.add_argument("--demo", action="store_true",
                       help="use the synthetic ground-truth scene")
        p.add_argument("--images", help="directory of NTF/TIFF acquisitions")
        p.add_argument("--kml", help="AOI polygon (with --images)")
        p.add_argument("--output", default="out")
        p.add_argument("--set", action="append",
                       help="config override, e.g. stereo.max_disp=128")
        p.add_argument("--device", default="cuda",
                       help="torch device the pipeline runs on "
                            "(default: cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {
        "list": cmd_list,
        "run": cmd_run,
        "height-map": cmd_height_map,
        "fuse": cmd_fuse,
        "stream": cmd_stream,
    }[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
