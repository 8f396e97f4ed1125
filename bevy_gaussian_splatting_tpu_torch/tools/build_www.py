"""Build the demo-gallery site (reference: tools/build_www.sh + www/, a wasm
demo gallery on GitHub Pages; the JAX package's ``tools/build_www.py``).

The deploy story is server-side rendering (``viewer/serve.py``), so the
build produces per-example thumbnails rendered through the port's headless
CLI and a static ``index.html`` gallery whose cards link to the viewer's
``/example/<id>`` route (live scene switching) and show the command that
reproduces each configuration.  ``--out`` is required: nothing is written
into the repository unless asked.

    python -m bevy_gaussian_splatting_tpu_torch.tools.build_www --out www_out [--device cpu]
    python -m bevy_gaussian_splatting_tpu_torch.tools.build_www --out www_out --no-render
    python -m bevy_gaussian_splatting_tpu_torch.viewer.serve --gallery www_out
"""

from __future__ import annotations

import argparse
import html
import json
import os
import shutil
import sys

from bevy_gaussian_splatting_tpu_torch.tools.render_thumbnails import MANIFEST

_PAGE_HEAD = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<title>bevy_gaussian_splatting_tpu_torch — example gallery</title><style>
 body { margin:0; background:#111; color:#ddd;
        font:14px/1.45 system-ui, monospace; }
 header { padding:18px 24px; border-bottom:1px solid #333; }
 h1 { margin:0; font-size:18px; }
 .sub { opacity:.6; font-size:12px; margin-top:4px; }
 .grid { display:grid; gap:16px; padding:24px;
         grid-template-columns:repeat(auto-fill, minmax(240px, 1fr)); }
 .card { background:#1a1a1a; border:1px solid #2c2c2c; border-radius:8px;
         overflow:hidden; }
 .card img { display:block; width:100%; image-rendering:pixelated;
             aspect-ratio:1; background:#000; }
 .card .body { padding:10px 12px; }
 .card h2 { margin:0 0 4px; font-size:14px; }
 .card p { margin:0 0 8px; font-size:12px; opacity:.75; }
 .tags span { display:inline-block; background:#26324a; color:#9cf;
              border-radius:3px; padding:1px 6px; margin-right:4px;
              font-size:11px; }
 code { display:block; background:#0d0d0d; border-radius:4px; padding:6px 8px;
        margin-top:8px; font-size:11px; white-space:pre-wrap;
        word-break:break-all; color:#8c8; }
 a.view { display:inline-block; margin-top:8px; color:#6cf;
          text-decoration:none; font-size:12px; }
</style></head><body>
<header><h1>bevy_gaussian_splatting_tpu_torch — example gallery</h1>
<div class="sub">server-rendered on the card · serve live with
<b>python -m bevy_gaussian_splatting_tpu_torch.viewer.serve --gallery DIR</b></div>
</header>
<div class="grid">
"""



def build_page(manifest: dict, thumb_prefix: str = "") -> str:
    cards = []
    for ex in manifest["examples"]:
        tags = "".join(f"<span>{html.escape(t)}</span>" for t in ex.get("tags", []))
        cmd = "python -m bevy_gaussian_splatting_tpu_torch.viewer.serve " + " ".join(
            ex["args"]
        )
        cards.append(
            f'<div class="card" id="{html.escape(ex["id"])}">'
            f'<a href="/example/{html.escape(ex["id"])}">'
            f'<img src="{thumb_prefix}{html.escape(ex["thumbnail"])}" '
            f'alt="{html.escape(ex["title"])}" loading="lazy"></a>'
            f'<div class="body"><h2>{html.escape(ex["title"])}</h2>'
            f'<p>{html.escape(ex["description"])}</p>'
            f'<div class="tags">{tags}</div>'
            f'<a class="view" href="/example/{html.escape(ex["id"])}">open in '
            f"viewer →</a>"
            f"<code>{html.escape(cmd)}</code>"
            f"</div></div>"
        )
    return _PAGE_HEAD + "\n".join(cards) + "\n</div></body></html>\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--manifest", default=MANIFEST)
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=192)
    p.add_argument("--no-render", action="store_true",
                   help="regenerate index.html without re-rendering thumbnails")
    p.add_argument("--only", default=None)
    p.add_argument("--device", default=None, help="torch device for the headless CLI (default: cuda)")
    args = p.parse_args(argv)

    with open(args.manifest) as f:
        manifest = json.load(f)

    os.makedirs(args.out, exist_ok=True)
    thumb_dir = os.path.join(args.out, "thumbnails")
    os.makedirs(thumb_dir, exist_ok=True)

    if not args.no_render:
        from bevy_gaussian_splatting_tpu_torch.tools.render_thumbnails import main as render_main

        rc = render_main(
            ["--manifest", args.manifest, "--out-dir", thumb_dir, "--size", str(args.size)]
            + (["--only", args.only] if args.only else [])
            + (["--device", args.device] if args.device else [])
        )
        if rc != 0:
            return rc

    # ship the manifest next to the page (the reference serves
    # www/examples/examples.json for its viewer links)
    os.makedirs(os.path.join(args.out, "examples"), exist_ok=True)
    shutil.copyfile(args.manifest, os.path.join(args.out, "examples", "examples.json"))
    index = os.path.join(args.out, "index.html")
    with open(index, "w") as f:
        f.write(build_page(manifest))
    print(f"gallery: {index} ({len(manifest['examples'])} examples)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
