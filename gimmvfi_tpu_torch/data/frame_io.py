"""Frame and optical-flow file IO (`gimmvfi_tpu/data/frame_io.py`).

Middlebury .flo read/write, PFM read, KITTI 16-bit png flow, binary PPM
read/write and a generic reader; everything returns channels-last numpy
float32. PPM (P6, 8-bit) is read and written with numpy alone, so frames in
that format need no image library; PNG/JPEG import Pillow (else cv2) and the KITTI
pngs cv2, each only when called.
"""

from __future__ import annotations

import os
import re

import numpy as np

_TAG = np.float32(202021.25)


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != _TAG:
            raise ValueError(f"invalid .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray):
    """(H, W, 2) float32 -> Middlebury .flo."""
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([_TAG], np.float32).tofile(f)
        np.array([w], np.int32).tofile(f)
        np.array([h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_pfm(path: str) -> np.ndarray:
    """PFM image -> float32 array, bottom row first in the file."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError("malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape))


def read_kitti_png_flow(path: str) -> tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit png -> (flow (H, W, 2), valid (H, W))."""
    import cv2

    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    raw = raw[:, :, ::-1].astype(np.float32)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    return (flow - 2**15) / 64.0, valid


def write_kitti_png_flow(path: str, flow: np.ndarray):
    """(H, W, 2) flow -> KITTI 16-bit png."""
    import cv2

    uv = 64.0 * flow + 2**15
    valid = np.ones((*flow.shape[:2], 1), np.float32)
    out = np.concatenate([uv, valid], axis=-1).astype(np.uint16)
    cv2.imwrite(path, out[..., ::-1])


def _ppm_header(f) -> tuple[int, int, int]:
    """(width, height, maxval) of a binary PPM; leaves `f` at the pixels.
    Header fields are separated by whitespace, `#` starts a comment, and
    one whitespace byte follows maxval."""
    fields = []
    while len(fields) < 4:
        byte = f.read(1)
        if not byte:
            raise ValueError("truncated PPM header")
        if byte == b"#":
            f.readline()
        elif byte.isspace():
            continue
        else:
            token = byte
            while True:
                byte = f.read(1)
                if not byte or byte.isspace():
                    break
                token += byte
            fields.append(token)
    if fields[0] != b"P6":
        raise ValueError(f"not a binary PPM (magic {fields[0]!r})")
    return int(fields[1]), int(fields[2]), int(fields[3])


def read_ppm(path: str) -> np.ndarray:
    """Binary PPM (P6, maxval 255) -> (H, W, 3) uint8, with numpy alone."""
    with open(path, "rb") as f:
        w, h, maxval = _ppm_header(f)
        if maxval != 255:
            raise ValueError(f"{path}: only 8-bit PPM (maxval 255) is read, got maxval {maxval}")
        data = np.fromfile(f, np.uint8, count=h * w * 3)
    if data.size != h * w * 3:
        raise ValueError(f"{path}: truncated PPM pixel data")
    return data.reshape(h, w, 3)


def write_ppm(path: str, rgb: np.ndarray):
    """(H, W, 3) uint8 RGB -> binary PPM (P6, maxval 255)."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_ppm takes (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb).tobytes())


def read_image(path: str) -> np.ndarray:
    """PPM/PNG/JPEG -> (H, W, 3) float32 in [0, 1]. PPM is read with numpy;
    the other formats with Pillow where it is installed, else with cv2
    (8-bit RGB either way); with neither the read raises."""
    if os.path.splitext(path)[-1].lower() == ".ppm":
        return read_ppm(path).astype(np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError:
        import cv2

        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise OSError(f"cv2 cannot read {path}")
        return np.ascontiguousarray(bgr[:, :, ::-1], np.float32) / 255.0
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def read_gen(path: str):
    """Reader chosen by the file's extension."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        return read_image(path)
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        return read_pfm(path).astype(np.float32)
    raise ValueError(f"unsupported extension: {ext}")
