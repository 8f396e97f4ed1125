"""Headless renderer CLI, the framework's ``examples/headless.rs``
equivalent (``viewer/headless.py`` of the JAX package).

Renders a cloud (a file, a streaming scene, a glTF scene, random, or the
deterministic test model) to a PNG.  The arguments are the JAX CLI's (the
reference's ``GaussianSplattingViewer`` clap args, src/utils.rs:7-112, where
they make sense without a window) plus ``--device``; without it the frame
renders on the card, and a missing card raises.

    python -m bevy_gaussian_splatting_tpu_torch.viewer.headless \\
        --gaussian-count 10000 --seed 0 --width 512 --height 512 -o out.png
    python -m bevy_gaussian_splatting_tpu_torch.viewer.headless --device cpu \\
        --input-cloud scene.gcloud --rasterize-mode depth -o depth.png
"""

from __future__ import annotations

import argparse
import os
import sys
import time as _time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input-cloud", type=str, default=None,
                   help=".ply/.gcloud/.ply4d/.gc4d/.npz cloud file (utils.rs input_cloud)")
    p.add_argument("--input-stream", type=str, default=None,
                   help="streaming-scene directory (stream/scene.py manifest);"
                        " loads chunks within --stream-radius of the eye")
    p.add_argument("--stream-radius", type=float, default=1e9,
                   help="chunk residency radius for --input-stream")
    p.add_argument("--input-scene", type=str, default=None,
                   help=".gltf/.glb KHR_gaussian_splatting scene (utils.rs input_scene)")
    p.add_argument("--gaussian-count", type=int, default=10_000,
                   help="random cloud size when no input file (utils.rs gaussian_count)")
    p.add_argument("--seed", type=int, default=0, help="random cloud seed")
    p.add_argument("--test-model", action="store_true",
                   help="use the deterministic 9-gaussian test cloud")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--gaussian-mode", default="gaussian_3d",
                   choices=["gaussian_2d", "gaussian_3d", "gaussian_4d"])
    p.add_argument("--rasterize-mode", default="color",
                   choices=["color", "depth", "normal", "position", "optical_flow",
                            "classification", "velocity"])
    p.add_argument("--draw-mode", default="all",
                   choices=["all", "selected", "highlight_selected"])
    p.add_argument("--aabb", action="store_true", help="AABB bounding quads (default OBB)")
    p.add_argument("--radix-bits", type=int, default=32, choices=[16, 24, 32])
    p.add_argument("--sort-mode", default="radix", choices=["none", "radix", "rayon", "std"])
    p.add_argument("--time", type=float, default=0.0, help="4D playback time")
    p.add_argument("--global-scale", type=float, default=1.0)
    p.add_argument("--global-opacity", type=float, default=1.0)
    p.add_argument("--eye", type=float, nargs=3, default=[0.0, 1.5, 5.0])
    p.add_argument("--target", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--background", type=float, nargs=4, default=[0.0, 0.0, 0.0, 0.0])
    p.add_argument("--impl", default="auto", choices=["auto", "oracle", "tiled"],
                   help="render() implementation: the tiled renderer (auto, tiled) or the painter (oracle)")
    p.add_argument("-o", "--output", type=str, default="headless_output/0.png",
                   help="output PNG path (reference writes headless_output/0.png)")
    p.add_argument("--benchmark", type=int, default=0, metavar="FRAMES",
                   help="render FRAMES timed frames after warmup and report FPS")
    p.add_argument("--device", default=None, help="torch device (default: cuda; a missing card raises)")
    return p


def load_source(args, dev, streaming_background: bool = False):
    """``(cloud, scene, stream)`` from the parsed arguments: a streaming
    scene, a glTF scene, a cloud file, the test model or a random cloud, on
    ``dev``.  A 4DGS cloud file switches ``args.gaussian_mode``."""
    from bevy_gaussian_splatting_tpu_torch.io.loader import load_cloud, load_scene, resolve_input
    from bevy_gaussian_splatting_tpu_torch.models.cloud import (
        Gaussian4dCloud,
        random_gaussians_3d_seeded,
        random_gaussians_4d_seeded,
        test_model_3d,
    )

    scene = stream = None
    if args.input_stream:
        from bevy_gaussian_splatting_tpu_torch.stream import StreamingCloudScene

        stream = StreamingCloudScene(
            args.input_stream, radius=args.stream_radius, background=streaming_background, device=dev
        )
        stream.update(tuple(args.eye))
        stream.wait_idle()
        cloud = stream.resident_cloud()
    elif args.input_scene:
        scene = load_scene(resolve_input(args.input_scene), device=dev)
        cloud = scene.clouds[0].cloud if scene.clouds else None
    elif args.input_cloud:
        cloud = load_cloud(resolve_input(args.input_cloud), device=dev)
        if isinstance(cloud, Gaussian4dCloud):
            args.gaussian_mode = "gaussian_4d"
    elif args.test_model:
        cloud = test_model_3d(device=dev)
    elif args.gaussian_mode == "gaussian_4d":
        cloud = random_gaussians_4d_seeded(args.gaussian_count, args.seed, device=dev)
    else:
        cloud = random_gaussians_3d_seeded(args.gaussian_count, args.seed, device=dev)
    return cloud, scene, stream


def settings_from_args(args):
    from bevy_gaussian_splatting_tpu_torch.models.settings import (
        CloudSettings,
        DrawMode,
        GaussianMode,
        RadixSortDepthBits,
        RasterizeMode,
        SortMode,
    )

    return CloudSettings(
        aabb=args.aabb,
        gaussian_mode=GaussianMode(args.gaussian_mode),
        rasterize_mode=RasterizeMode(args.rasterize_mode),
        draw_mode=DrawMode(args.draw_mode),
        sort_mode=SortMode(args.sort_mode),
        radix_sort_depth_bits=RadixSortDepthBits(args.radix_bits),
        time=args.time,
        global_scale=args.global_scale,
        global_opacity=args.global_opacity,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from bevy_gaussian_splatting_tpu_torch.device import resolve_device
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.render.api import render
    from bevy_gaussian_splatting_tpu_torch.render.scene import camera_from_scene, render_scene
    from bevy_gaussian_splatting_tpu_torch.utils.image import non_black_pixel_count, save_png

    dev = resolve_device(args.device)
    cloud, scene, stream = load_source(args, dev)
    if stream is not None:
        if cloud is None:
            print("no chunks within --stream-radius of the eye", flush=True)
            return 1
        print(
            f"streaming: {len(stream.resident_ids())}/{len(stream.entries)} "
            f"chunks resident ({len(cloud)} gaussians padded)",
            flush=True,
        )

    settings = settings_from_args(args)
    camera = None
    if scene is not None:
        camera = camera_from_scene(scene, args.width, args.height, device=dev)
        if camera is not None:
            print("using scene camera", flush=True)
    if camera is None:
        camera = Camera.create(
            eye=tuple(args.eye), target=tuple(args.target), width=args.width, height=args.height, device=dev
        )
    background = torch.tensor(args.background, dtype=torch.float32, device=dev)

    def draw():
        if scene is not None:
            return render_scene(scene, camera, background=background, impl=args.impl, device=dev)
        return render(cloud, camera, settings, background=background, impl=args.impl, device=dev)

    def finish():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = _time.perf_counter()
    image = draw()
    finish()
    t1 = _time.perf_counter()
    print(f"first frame (incl. kernel build): {t1 - t0:.3f}s")

    if args.benchmark:
        for _ in range(3):  # warmup
            draw()
        finish()
        t2 = _time.perf_counter()
        for _ in range(args.benchmark):
            image = draw()
        finish()
        t3 = _time.perf_counter()
        per_frame = (t3 - t2) / args.benchmark
        rays = args.width * args.height / per_frame
        print(f"steady state: {per_frame * 1e3:.2f} ms/frame  "
              f"({1.0 / per_frame:.1f} fps, {rays / 1e6:.2f} Mrays/s)")

    out_dir = os.path.dirname(args.output)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    save_png(image, args.output)
    print(f"wrote {args.output} ({args.width}x{args.height}, "
          f"{non_black_pixel_count(image)} non-black pixels)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
