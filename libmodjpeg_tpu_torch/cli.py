"""modjpeg-compatible CLI on a torch device (PyTorch port of
libmodjpeg_tpu.cli, contrib/modjpeg.c parity).

    python -m libmodjpeg_tpu_torch.cli -i in.jpg -p br -d logo.png -o out.jpg

Flag surface and ORDER-DEPENDENT evaluation mirror the reference's getopt
state machine (modjpeg.c:52-179): `-i` loads, `-d` composes immediately at
the current position state, effects apply immediately, `-o` writes with the
accumulated options.  Multiple dropons/outputs per invocation work.  The
flags, messages and exit codes are the JAX package's; the torch device is
the ``device`` keyword of ``main`` ("cuda" from the command line), not a
flag.

Quirk preserved: the default position is top-left (modjpeg.c:53) even though
the reference's --help claims center.
"""

from __future__ import annotations

import sys

from . import constants as C
from .errors import ModJpegError
from .jpegio import read_jpeg, write_jpeg

from . import compose
from . import effects as fx
from .dropon import read_dropon

HELP = """\
modjpeg (libmodjpeg_tpu)

The order for the options is important, i.e. a dropon can't be applied without
loading an image first.

Options:

\t--input, -i file
\t\tPath to the image to be modified. The image needs to be a JPEG.

\t--ouput, -o file
\t\tPath to a file to store the modified image in.

\t--dropon, -d file[,mask]
\t\tPath to the image that should be used as dropon. The path to the mask is optional.

\t--position, -p [t|b][c][l|r]
\t\tThe position of the dropon. t = top, b = bottom, l = left, r = right, c = center. Default: center

\t--offset, -m [horizontal],[vertical]
\t\tThe offset to the given position in pixels. Default: 0,0

\t--luminance, -y value
\t\tChanges the brightness of the image according to the value.

\t--tintblue, -b value
\t\tColor the image (negative: yellow, positive: blue).

\t--tintred, -r value
\t\tColor the image (negative: green, positive: red).

\t--pixelate, -x
\t\tPixelate the image into 8x8 blocks.

\t--grayscale, -g
\t\tReduce the image to grayscale.

\t--optimize, -O
\t\tOptimize the Huffman tables on storing the output image.

\t--progressive, -P
\t\tStore the output image in progressive mode.

\t--arithmetric, -A
\t\tUse arithmetric coding instead of Huffman coding.

\t--restart-interval, -R n
\t\tEmit a restart marker every n MCUs (enables parallel decode downstream).

\t--allow-cmyk, -C
\t\tAdmit 4-component Adobe CMYK/YCCK input images (extension; the
\t\treference rejects these). Applies to subsequent -i options.

\t--bitexact, -X
\t\tReference byte-parity mode (extension): composes and writes so the
\t\toutput file is byte-identical to the reference modjpeg binary.
"""

_LONG = {
    "--input": "-i", "--output": "-o", "--dropon": "-d", "--position": "-p",
    "--offset": "-m", "--luminance": "-y", "--tintblue": "-b",
    "--tintred": "-r", "--pixelate": "-x", "--grayscale": "-g",
    "--progressive": "-P", "--optimize": "-O", "--arithmetric": "-A",
    "--restart-interval": "-R", "--allow-cmyk": "-C", "--bitexact": "-X",
    "--help": "-h",
}
_TAKES_ARG = {"-i", "-o", "-d", "-p", "-m", "-y", "-b", "-r", "-R"}


def main(argv=None, device="cuda") -> int:
    """Run the CLI on ``argv`` (default: sys.argv[1:]); dropon decoding,
    compose and effects run on ``device``.  Returns the exit code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    img = None
    position = C.ALIGN_TOP | C.ALIGN_LEFT  # modjpeg.c:53
    offset_x = offset_y = 0
    options = 0
    restart_interval = None  # new vs reference: parallel-codec control
    allow_cmyk = False       # new vs reference: 4-component input opt-in
    bitexact = False         # new vs reference: byte-parity compose mode

    i = 0
    while i < len(argv):
        arg = argv[i]
        i += 1
        if arg.startswith("--") and "=" in arg:
            name, _, val = arg.partition("=")
            arg = _LONG.get(name, name)
            argv.insert(i, val)
        elif arg in _LONG:
            arg = _LONG[arg]
        if arg in _TAKES_ARG:
            if i >= len(argv):
                print("Argument missing, use --help for more details",
                      file=sys.stderr)
                continue
            val = argv[i]
            i += 1
        else:
            val = None

        try:
            if arg == "-i":
                img = read_jpeg(val, allow_cmyk=allow_cmyk)
            elif arg == "-o":
                if img is None:
                    print(f"Can't write image to '{val}'", file=sys.stderr)
                    return 1
                write_jpeg(img, val, options=options,
                           restart_interval=restart_interval,
                           ref_markers=bitexact)
            elif arg == "-d":
                if "," in val:
                    dropon_path, mask_path = val.split(",", 1)
                else:
                    dropon_path, mask_path = val, None
                try:
                    d = read_dropon(dropon_path, mask=mask_path,
                                    blend=C.BLEND_FULL, device=device)
                except ModJpegError:
                    print(f"Can't read dropon from '{dropon_path}'",
                          file=sys.stderr)
                    return 1
                if img is None:
                    print("Failed to apply the dropon onto the image",
                          file=sys.stderr)
                    return 1
                img = compose(img, d, position, offset_x, offset_y,
                              bitexact=bitexact, device=device)
            elif arg == "-p":
                # reference parity: modjpeg.c:100-127 indexes optarg[0] and
                # optarg[1] without a length gate — a 1-char arg applies only
                # the vertical flag, extra chars are ignored
                position = 0
                v0 = val[0] if len(val) > 0 else ""
                v1 = val[1] if len(val) > 1 else ""
                if v0 == "t":
                    position |= C.ALIGN_TOP
                elif v0 == "b":
                    position |= C.ALIGN_BOTTOM
                elif v0 == "c":
                    position |= C.ALIGN_CENTER
                if v1 == "l":
                    position |= C.ALIGN_LEFT
                elif v1 == "r":
                    position |= C.ALIGN_RIGHT
                elif v1 == "c":
                    position |= C.ALIGN_CENTER
            elif arg == "-m":
                parts = val.split(",")
                try:
                    offset_x = int(parts[0]) if parts[0] else 0
                except ValueError:
                    offset_x = 0
                if len(parts) > 1:
                    try:
                        offset_y = int(parts[1])
                    except ValueError:
                        offset_y = 0
            elif arg == "-y":
                if img is not None:
                    img = fx.luminance(img, int(val), device=device)
            elif arg == "-b":
                if img is not None:
                    img = fx.tint(img, int(val), 0, device=device)
            elif arg == "-r":
                if img is not None:
                    img = fx.tint(img, 0, int(val), device=device)
            elif arg == "-x":
                if img is not None:
                    img = fx.pixelate(img, device=device)
            elif arg == "-g":
                if img is not None:
                    img = fx.grayscale(img, device=device)
            elif arg == "-R":
                try:
                    restart_interval = int(val)
                except (TypeError, ValueError):
                    print("Invalid restart interval", file=sys.stderr)
            elif arg == "-C":
                allow_cmyk = True
            elif arg == "-X":
                bitexact = True
            elif arg == "-O":
                options |= C.OPTION_OPTIMIZE
            elif arg == "-P":
                options |= C.OPTION_PROGRESSIVE
            elif arg == "-A":
                options |= C.OPTION_ARITHMETRIC
            elif arg == "-h":
                print(HELP, file=sys.stderr)
                return 0
            else:
                print("Unknown option, use --help for more details",
                      file=sys.stderr)
        except ModJpegError as e:
            if arg == "-i":
                print(f"Can't read image from '{val}'", file=sys.stderr)
            elif arg == "-o":
                print(f"Can't write image to '{val}'", file=sys.stderr)
            else:
                print(f"error: {e}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
