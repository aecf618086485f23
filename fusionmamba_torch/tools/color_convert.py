"""Offline colour-space CLI of the port (the counterpart of
`tools/color_convert.py`; reference `RGB2Y.py`, `YtoRGB.py`,
`changesizeandY2RGB`).

    python -m fusionmamba_torch.tools.color_convert rgb2y --input RGB --output Y
    python -m fusionmamba_torch.tools.color_convert y2rgb --fused FUSED --rgb RGB --output OUT

  rgb2y  extracts the Y (luma) channel of every image of a folder (to
         prepare PET/SPECT inputs; `RGB2Y.py:19-29`);
  y2rgb  puts fused Y images back into the chroma of the original RGB folder
         (`YtoRGB.py:12-27`, resized as `changesizeandY2RGB` does).
Both run on the host (`data/color.py`), in numpy and PIL.
"""
from __future__ import annotations

import argparse

from ..data.color import extract_y_dir, reinject_y_dir


def main(argv=None) -> int:
    """Run the CLI; returns the number of images written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("rgb2y", help="extract Y channel from RGB folder")
    p1.add_argument("--input", required=True)
    p1.add_argument("--output", required=True)
    p2 = sub.add_parser("y2rgb", help="re-inject fused Y into RGB chroma")
    p2.add_argument("--fused", required=True, help="fused Y images folder")
    p2.add_argument("--rgb", required=True, help="original RGB folder")
    p2.add_argument("--output", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "rgb2y":
        n = extract_y_dir(args.input, args.output)
    else:
        n = reinject_y_dir(args.fused, args.rgb, args.output)
    print(f"{args.cmd}: wrote {n} images to {args.output}")
    return n


if __name__ == "__main__":
    main()
