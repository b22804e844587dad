"""The port's copy of libmodjpeg_tpu.constants (public constants).

Mirrors the constant surface of the reference library
(libmodjpeg.h:38-69) so that users of the reference find
the same vocabulary here: colorspaces, alignment flags, blend sentinels,
encode options and error codes.
"""

VERSION = (1, 0, 2)
VERSION_STR = "1.0.2"

# -- input colorspaces for raw dropon buffers (libmodjpeg.h:38-43) ----------
COLORSPACE_RGB = 1
COLORSPACE_RGBA = 2
COLORSPACE_GRAYSCALE = 3
COLORSPACE_GRAYSCALEA = 4
COLORSPACE_YCC = 5
COLORSPACE_YCCA = 6

# -- JPEG internal colorspaces (J_COLOR_SPACE analog) -----------------------
JCS_UNKNOWN = 0
JCS_GRAYSCALE = 1
JCS_RGB = 2
JCS_YCbCr = 3
JCS_CMYK = 4
JCS_YCCK = 5

# -- placement alignment flags (libmodjpeg.h:45-49) -------------------------
ALIGN_LEFT = 1 << 0
ALIGN_RIGHT = 1 << 1
ALIGN_TOP = 1 << 2
ALIGN_BOTTOM = 1 << 3
ALIGN_CENTER = 1 << 4

# -- blend sentinels (libmodjpeg.h:51-53) -----------------------------------
BLEND_NONUNIFORM = -1
BLEND_NONE = 0
BLEND_FULL = 255

# -- encode options (libmodjpeg.h:55-58) ------------------------------------
OPTION_NONE = 0
OPTION_OPTIMIZE = 1 << 0
OPTION_PROGRESSIVE = 1 << 1
OPTION_ARITHMETRIC = 1 << 2  # reference spelling, kept for API parity
OPTION_ARITHMETIC = OPTION_ARITHMETRIC

# -- error codes (libmodjpeg.h:60-69) ---------------------------------------
OK = 0
ERR_MEMORY = 1
ERR_NULL_DATA = 2
ERR_DROPON_DIMENSIONS = 3
ERR_UNSUPPORTED_COLORSPACE = 4
ERR_DECODE_JPEG = 5
ERR_ENCODE_JPEG = 6
ERR_FILEIO = 7
ERR_IMAGE_SIZE = 8
ERR_UNSUPPORTED_FILETYPE = 9

DCTSIZE = 8
DCTSIZE2 = 64

# Zigzag order: ZIGZAG[k] = natural index of the k-th zigzag coefficient.
ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
)
