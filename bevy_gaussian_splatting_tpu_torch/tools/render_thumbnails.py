"""Example-gallery thumbnail harness (reference: tests/headless_examples.rs +
tools/build_www.sh thumbnail generation; the JAX package's
``tools/render_thumbnails.py``).

Renders every entry of an examples manifest (default: the repository's
``examples/examples.json``) through the port's headless CLI into
``--out-dir``, which is required: nothing is written into the repository
unless asked.  Exits non-zero if any example fails or renders an image with
no lit pixel: this is the gallery smoke test.

    python -m bevy_gaussian_splatting_tpu_torch.tools.render_thumbnails --out-dir thumbs [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MANIFEST = os.path.join(ROOT, "examples", "examples.json")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--manifest", default=MANIFEST)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--only", default=None, help="render just this example id")
    p.add_argument("--device", default=None, help="torch device for the headless CLI (default: cuda)")
    args = p.parse_args(argv)

    from bevy_gaussian_splatting_tpu_torch.utils.image import load_png, non_black_pixel_count
    from bevy_gaussian_splatting_tpu_torch.viewer import headless

    with open(args.manifest) as f:
        manifest = json.load(f)
    os.makedirs(args.out_dir, exist_ok=True)

    failures = []
    for ex in manifest["examples"]:
        if args.only and ex["id"] != args.only:
            continue
        out = os.path.join(args.out_dir, f"{ex['id']}.png")
        argv_ex = ["--width", str(args.size), "--height", str(args.size), *ex["args"], "-o", out]
        if args.device:
            argv_ex += ["--device", args.device]
        try:  # one example's failure is reported and the others still render
            rc = headless.main(argv_ex)
        except Exception:
            traceback.print_exc()
            rc = 1
        lit = non_black_pixel_count(load_png(out)) if rc == 0 and os.path.exists(out) else 0
        if lit:
            print(f"[ok] {ex['id']}: {lit} non-black pixels")
        else:
            failures.append(ex["id"])
            print(f"[FAIL] {ex['id']}: rc {rc}, {lit} non-black pixels")

    if failures:
        print(f"{len(failures)} example(s) failed: {failures}")
        return 1
    print(f"all thumbnails in {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
