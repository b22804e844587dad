"""The port's copy of libmodjpeg_tpu.errors (the error taxonomy).

The reference reports integer codes (libmodjpeg.h:60-69). We raise typed
exceptions carrying the equivalent code so the 10-code contract is preserved
for users that want it (``exc.code``), while the Python API stays idiomatic.
"""

from . import constants as C


class ModJpegError(Exception):
    code = -1


class MemoryError_(ModJpegError):
    code = C.ERR_MEMORY


class NullDataError(ModJpegError):
    code = C.ERR_NULL_DATA


class DroponDimensionsError(ModJpegError):
    code = C.ERR_DROPON_DIMENSIONS


class UnsupportedColorspaceError(ModJpegError):
    code = C.ERR_UNSUPPORTED_COLORSPACE


class DecodeError(ModJpegError):
    code = C.ERR_DECODE_JPEG


class EncodeError(ModJpegError):
    code = C.ERR_ENCODE_JPEG


class FileIOError(ModJpegError):
    code = C.ERR_FILEIO


class ImageSizeError(ModJpegError):
    code = C.ERR_IMAGE_SIZE


class UnsupportedFiletypeError(ModJpegError):
    code = C.ERR_UNSUPPORTED_FILETYPE


CODE_TO_ERROR = {
    cls.code: cls
    for cls in (
        MemoryError_,
        NullDataError,
        DroponDimensionsError,
        UnsupportedColorspaceError,
        DecodeError,
        EncodeError,
        FileIOError,
        ImageSizeError,
        UnsupportedFiletypeError,
    )
}
