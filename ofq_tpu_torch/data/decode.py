"""Image decoding: the counterpart of `tf.io.decode_image(contents,
channels=3, expand_animations=False)` in the JAX package's input pipeline
(`ofq_tpu/data/pipeline.py`, `load_train` and `load_eval`).

The form is read from the file's first bytes, never from its name
(ImageNet's train split holds a PNG named `n02105855_2933.JPEG`).  Every
form comes out as uint8 (H, W, 3) on the caller's device:

  * JPEG on the card only, through nvJPEG (`csrc/image_decode.cu`, a
    library call of the CUDA toolkit, built and loaded with ctypes like the
    kernels): the pixels never pass through the host.  A JPEG on the CPU
    raises: the CPU reads PNG, BMP and GIF.  A 4-component frame (CMYK, or
    YCCK under an Adobe APP14 marker whose transform byte is not 0; a few
    of ImageNet's train files) is decoded by nvJPEG to its four planes and
    converted by the `ofq_cmyk_to_rgb` kernel (`cmyk_to_rgb`; its plain
    version `cmyk_to_rgb_reference`) as TensorFlow's libjpeg decode
    converts it.  A JPEG that nvJPEG cannot decode raises, naming the file
    and the form;
  * PNG (zlib from the standard library and the five row filters, Adam7
    interlacing, every bit depth and colour type), BMP (uncompressed 24-
    and 32-bit) and GIF (LZW, interlacing, the global and local colour
    tables; the first frame, on its canvas, as TensorFlow's giflib decode
    lays it: outside the frame's rectangle and at its transparent index
    black) in numpy on the host, then moved to the device.  As with
    TensorFlow's `channels=3`, alpha is dropped, grey is repeated into three
    channels, a palette is looked up and 16-bit samples keep their high
    byte;
  * anything else raises, naming the file and the form, as does a
    malformed PNG, BMP or GIF.  Nothing falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np
import torch

from ..ops import _build

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def image_form(data: bytes) -> str:
    """'jpeg', 'png', 'bmp', 'gif' or 'unknown', from the leading bytes."""
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:8] == PNG_MAGIC:
        return "png"
    if data[:2] == b"BM":
        return "bmp"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    return "unknown"


class DecodeError(ValueError):
    """A file that the port does not decode; the message names it and its
    form."""


def decode_image(data: bytes, path: str, device) -> torch.Tensor:
    """uint8 (H, W, 3) on `device` from the bytes of the file at `path`."""
    device = torch.device(device)
    form = image_form(data)
    if form == "jpeg":
        if device.type != "cuda":
            raise DecodeError(
                f"{path}: a JPEG decodes on the card (nvJPEG); on the CPU "
                "the port reads PNG, BMP and GIF")
        return decode_jpeg(data, path, device)
    if form == "png":
        img = decode_png(data, path)
    elif form == "bmp":
        img = decode_bmp(data, path)
    elif form == "gif":
        img = decode_gif(data, path)
    else:
        raise DecodeError(f"{path}: an unknown form is not decoded by the "
                          "port (JPEG on the card, PNG, BMP and GIF "
                          "anywhere)")
    return torch.from_numpy(img).to(device)


# ------------------------------------------------------------------ PNG
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int, path: str
              ) -> np.ndarray:
    """Undo the PNG row filters of `rows` rows of `stride` bytes (each led
    by its filter byte); bytes are grouped by `bpp`, the filters' unit.
    Every byte depends on its left, upper and upper-left neighbours only,
    so the anti-diagonals of the (row, pixel) grid are decoded one at a
    time, each in one vector step."""
    data = raw[:rows * (stride + 1)].reshape(rows, stride + 1)
    ftype = data[:, 0].astype(np.int64)
    if ftype.size and ftype.max() > 4:
        raise DecodeError(f"{path}: PNG row filter {ftype.max()} is not one "
                          "of the five")
    cur = data[:, 1:].astype(np.int32)
    npx = stride // bpp
    cur = cur.reshape(rows, npx, bpp)
    if not ftype.any():
        return cur.reshape(rows, stride).astype(np.uint8)
    out = np.zeros((rows + 1, npx + 1, bpp), np.int32)
    for k in range(rows + npx - 1):
        r = np.arange(max(0, k - npx + 1), min(rows, k + 1))
        c = k - r
        a = out[r + 1, c]
        b = out[r, c + 1]
        d = out[r, c]
        ft = ftype[r][:, None]
        p = a + b - d
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - d)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, d))
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, c + 1] = (cur[r, c] + pred) & 255
    return out[1:, 1:].reshape(rows, stride).astype(np.uint8)


def _samples(rows: np.ndarray, width: int, channels: int, depth: int
             ) -> np.ndarray:
    """Unfiltered rows -> (H, width, channels) samples as integers."""
    h = rows.shape[0]
    if depth == 16:
        v = rows.reshape(h, -1).view(">u2").astype(np.int32)
    elif depth == 8:
        v = rows.astype(np.int32)
    else:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        v = (bits * weights).sum(-1).astype(np.int32)
    return v[:, :width * channels].reshape(h, width, channels)


def decode_png(data: bytes, path: str) -> np.ndarray:
    """uint8 (H, W, 3) of a PNG file, as `tf.io.decode_image(channels=3)`
    gives it."""
    pos, idat, plte, hdr = 8, [], None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None or not idat:
        raise DecodeError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise DecodeError(f"{path}: PNG colour type {ctype} at bit depth "
                          f"{depth} is not a PNG form")
    if ctype == 3 and plte is None:
        raise DecodeError(f"{path}: palette PNG without PLTE")
    ch = _PNG_CHANNELS[ctype]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise DecodeError(f"{path}: PNG data does not inflate: {e}") from None
    bpp = max(1, ch * depth // 8)

    def rows_of(w, h, offset):
        stride = (w * ch * depth + 7) // 8
        need = h * (stride + 1)
        if raw.size < offset + need:
            raise DecodeError(f"{path}: PNG data ends early")
        rows = _unfilter(raw[offset:offset + need], h, stride, bpp, path)
        return _samples(rows, w, ch, depth), offset + need

    if interlace == 0:
        v, _ = rows_of(width, height, 0)
    else:
        v = np.zeros((height, width, ch), np.int32)
        off = 0
        for r0, c0, dr, dc in _ADAM7:
            pw = (width - c0 + dc - 1) // dc if width > c0 else 0
            ph = (height - r0 + dr - 1) // dr if height > r0 else 0
            if pw and ph:
                sub, off = rows_of(pw, ph, off)
                v[r0::dr, c0::dc] = sub
    if ctype == 3:
        idx = np.minimum(v[..., 0], len(plte) - 1)
        return np.ascontiguousarray(plte[idx])
    if depth == 16:
        v = v >> 8
    elif depth < 8:
        v = v * (255 // ((1 << depth) - 1))
    if ch <= 2:  # grey, grey + alpha
        v = np.repeat(v[..., :1], 3, axis=-1)
    else:        # RGB, RGBA
        v = v[..., :3]
    return np.ascontiguousarray(v.astype(np.uint8))


# ------------------------------------------------------------------ BMP
def decode_bmp(data: bytes, path: str) -> np.ndarray:
    """uint8 (H, W, 3) of an uncompressed 24- or 32-bit BMP (rows bottom-up,
    or top-down with a negative height)."""
    if len(data) < 30:
        raise DecodeError(f"{path}: BMP header cut short")
    offset = struct.unpack("<I", data[10:14])[0]
    hsize = struct.unpack("<I", data[14:18])[0]
    if hsize == 12:
        width, height, _, bits = struct.unpack("<hhHH", data[18:26])
        compression = 0
    else:
        width, height, _, bits, compression = struct.unpack(
            "<iiHHI", data[18:34])
    if bits not in (24, 32) or compression not in (0, 3) or (
            compression == 3 and bits != 32):
        raise DecodeError(f"{path}: BMP of {bits} bits a pixel, compression "
                          f"{compression}: the port reads uncompressed 24- "
                          "and 32-bit BMP")
    top_down = height < 0
    height = abs(height)
    step = bits // 8
    stride = (width * step + 3) & ~3
    px = np.frombuffer(data, np.uint8, count=height * stride, offset=offset)
    px = px.reshape(height, stride)[:, :width * step].reshape(
        height, width, step)
    if not top_down:
        px = px[::-1]
    return np.ascontiguousarray(px[..., 2::-1])


# ------------------------------------------------------------------ GIF
def _gif_blocks(data: bytes, pos: int, path: str) -> tuple[bytes, int]:
    """The concatenated data sub-blocks from `pos` and the position after
    their terminator."""
    out = []
    while True:
        if pos >= len(data):
            raise DecodeError(f"{path}: GIF data ends inside a block")
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(out), pos
        out.append(data[pos:pos + n])
        pos += n


def _lzw(raw: bytes, min_size: int, count: int, path: str) -> np.ndarray:
    """`count` colour indices of a GIF image's LZW stream (codes packed
    LSB first, clear and end codes, widths up to 12 bits)."""
    if not 2 <= min_size <= 8:
        raise DecodeError(f"{path}: GIF LZW minimum code size {min_size}")
    clear, end = 1 << min_size, (1 << min_size) + 1
    nbits = len(raw) * 8
    raw = raw + b"\0\0\0"
    out = bytearray()
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    size, pos, prev = min_size + 1, 0, None
    while len(out) < count:
        if pos + size > nbits:
            raise DecodeError(f"{path}: GIF LZW data ends early")
        byte = pos >> 3
        code = (int.from_bytes(raw[byte:byte + 3], "little") >> (pos & 7)
                ) & ((1 << size) - 1)
        pos += size
        if code == clear:
            table = table[:end + 1]
            size, prev = min_size + 1, None
            continue
        if code == end:
            break
        if code < len(table):
            entry = table[code]
            if prev is not None and len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table) and prev is not None and code < 4096:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise DecodeError(f"{path}: GIF LZW code {code} out of range")
        out += entry
        prev = entry
        if len(table) == (1 << size) and size < 12:
            size += 1
    if len(out) < count:
        raise DecodeError(f"{path}: GIF image holds {len(out)} of {count} "
                          "pixels")
    return np.frombuffer(bytes(out[:count]), np.uint8)


def _gif_table(data: bytes, pos: int, packed: int, path: str):
    n = 3 << ((packed & 7) + 1)
    if pos + n > len(data):
        raise DecodeError(f"{path}: GIF colour table cut short")
    return np.frombuffer(data, np.uint8, n, pos).reshape(-1, 3), pos + n


def decode_gif(data: bytes, path: str) -> np.ndarray:
    """uint8 (H, W, 3) of a GIF's first frame as `tf.io.decode_image(
    channels=3, expand_animations=False)` gives it (TensorFlow's giflib
    decode, `tensorflow/core/lib/gif/gif_io.cc`): the canvas is the largest
    width and height of the file's frames (not its logical screen), the
    first frame's pixels from its local colour table, else the global one,
    at its offset, cut to the canvas; the rest of the canvas, and the
    pixels at the transparent index of the frame's graphic control
    extension, black."""
    if len(data) < 13:
        raise DecodeError(f"{path}: GIF header cut short")
    packed = data[10]
    pos, gtable, transparent, gce, first = 13, None, None, None, None
    if packed & 0x80:
        gtable, pos = _gif_table(data, pos, packed, path)
    sizes = []
    while True:
        if pos >= len(data):
            raise DecodeError(f"{path}: GIF without its trailer")
        kind = data[pos]
        if kind == 0x21:                       # an extension
            if pos + 2 > len(data):
                raise DecodeError(f"{path}: GIF extension cut short")
            label = data[pos + 1]
            body, pos = _gif_blocks(data, pos + 2, path)
            if label == 0xF9 and len(body) >= 4:
                gce = body[3] if body[0] & 1 else None
        elif kind == 0x2C:                     # an image
            if pos + 10 > len(data):
                raise DecodeError(f"{path}: GIF image descriptor cut short")
            left, top, w, h, ipacked = struct.unpack(
                "<HHHHB", data[pos + 1:pos + 10])
            pos += 10
            table = gtable
            if ipacked & 0x80:
                table, pos = _gif_table(data, pos, ipacked, path)
            if pos >= len(data):
                raise DecodeError(f"{path}: GIF image data missing")
            raw, end = _gif_blocks(data, pos + 1, path)
            if first is None:
                if table is None:
                    raise DecodeError(f"{path}: GIF without a colour table")
                first = (left, top, w, h, ipacked, table, data[pos], raw)
                transparent = gce
            sizes.append((h, w))
            pos, gce = end, None
        elif kind == 0x3B:
            break
        else:
            raise DecodeError(f"{path}: GIF block 0x{kind:02x} is not one "
                              "of GIF's")
    if first is None:
        raise DecodeError(f"{path}: GIF without an image")
    left, top, w, h, ipacked, table, min_size, raw = first
    idx = _lzw(raw, min_size, w * h, path).reshape(h, w)
    if ipacked & 0x40:                         # interlaced rows, in order
        order = np.concatenate([np.arange(r0, h, dr) for r0, dr in
                                ((0, 8), (4, 8), (2, 4), (1, 2))])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    if idx.size and int(idx.max()) >= len(table):
        raise DecodeError(f"{path}: GIF colour index {int(idx.max())} past "
                          f"its table of {len(table)}")
    height, width = (max(s[i] for s in sizes) for i in (0, 1))
    out = np.zeros((height, width, 3), np.uint8)
    y1, x1 = min(top + h, height), min(left + w, width)
    if top < y1 and left < x1:
        frame = idx[:y1 - top, :x1 - left]
        px = table[frame]
        if transparent is not None:
            px[frame == transparent] = 0
        out[top:y1, left:x1] = px
    return out


# ----------------------------------------------------------------- JPEG
# nvjpegStatus_t
_NVJPEG_STATUS = {
    1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG",
    4: "JPEG_NOT_SUPPORTED", 5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED",
    7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR", 9: "IMPLEMENTATION_NOT_SUPPORTED",
    10: "INCOMPLETE_BITSTREAM"}
# nvjpegChromaSubsampling_t
CHROMA = {0: "4:4:4", 1: "4:2:2", 2: "4:2:0", 3: "4:4:0", 4: "4:1:1",
          5: "4:1:0", 6: "grey", 7: "4:1:0V", -1: "unknown"}

# device index -> the library's decoder (one nvJPEG handle and state)
_DECODERS: dict[int, int] = {}


def _lib():
    lib = _build.load("image_decode")
    if not getattr(lib, "_ofq_typed", False):
        lib.ofq_jpeg_open.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        lib.ofq_jpeg_open.restype = ctypes.c_int
        lib.ofq_jpeg_info.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_size_t,
                                      ctypes.POINTER(ctypes.c_int)]
        lib.ofq_jpeg_info.restype = ctypes.c_int
        lib.ofq_jpeg_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.ofq_jpeg_decode.restype = ctypes.c_int
        lib.ofq_jpeg_decode_planes.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p]
        lib.ofq_jpeg_decode_planes.restype = ctypes.c_int
        lib.ofq_cmyk_to_rgb.argtypes = [
            ctypes.POINTER(ctypes.c_void_p)] + [
            ctypes.POINTER(ctypes.c_int)] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.ofq_cmyk_to_rgb.restype = ctypes.c_int
        lib._ofq_typed = True
    return lib


def _decoder(lib, device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    h = _DECODERS.get(idx)
    if h is None:
        handle = ctypes.c_void_p()
        with torch.cuda.device(idx):
            st = lib.ofq_jpeg_open(ctypes.byref(handle))
        if st != 0:
            raise RuntimeError(f"nvJPEG did not start on cuda:{idx}: "
                               f"{_NVJPEG_STATUS.get(st, st)}")
        h = _DECODERS[idx] = handle.value
    return h


def jpeg_info(data: bytes, path: str, device) -> dict:
    """The header as nvJPEG reads it: components, chroma subsampling,
    width, height, progressive, and each component's (height, width)
    (`planes`)."""
    lib = _lib()
    device = torch.device(device)
    info = (ctypes.c_int * 13)()
    st = lib.ofq_jpeg_info(_decoder(lib, device), data, len(data), info)
    if st != 0:
        raise DecodeError(f"{path}: nvJPEG cannot read the JPEG header: "
                          f"{_NVJPEG_STATUS.get(st, st)}")
    return dict(components=info[0], chroma=CHROMA.get(info[1], str(info[1])),
                width=info[2], height=info[3], progressive=info[4] == 1,
                planes=[(info[6 + 2 * c], info[5 + 2 * c])
                        for c in range(info[0])])


def adobe_transform(data: bytes):
    """The transform byte of the JPEG's Adobe APP14 marker (0 CMYK, 2
    YCCK), or None without one; read as libjpeg reads it (jdmarker.c: an
    APP14 of at least 12 bytes that begins `Adobe`), from the markers
    before the first scan."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xDA or marker == 0xD9:
            break
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + n]
        if marker == 0xEE and len(body) >= 12 and body[:5] == b"Adobe":
            return body[11]
        pos += 2 + n
    return None


def cmyk_to_rgb_reference(planes, ycck: bool, adobe: bool, height: int,
                          width: int) -> torch.Tensor:
    """The plain version of `ofq_cmyk_to_rgb` (`csrc/image_decode.cu`): the
    same integer arithmetic on the four uint8 planes (each (h, w), read at
    floor(y h / H), floor(x w / W)).  YCCK to CMYK by libjpeg's
    fixed-point tables (`ycck_cmyk_convert`), then TensorFlow's CMYK to
    RGB: R = C K / 255 with an Adobe marker, (255 - C)(255 - K) / 255
    without; integer division."""
    dev = planes[0].device
    ys = torch.arange(height, device=dev, dtype=torch.int64)
    xs = torch.arange(width, device=dev, dtype=torch.int64)
    v = []
    for p in planes:
        h, w = p.shape
        r = ys if h == height else ys * h // height
        c = xs if w == width else xs * w // width
        v.append(p.to(torch.int64)[r][:, c])
    if ycck:
        y, cb, cr = v[0], v[1] - 128, v[2] - 128
        half, sc = 1 << 15, 16
        r = y + ((91881 * cr + half) >> sc)
        g = y + ((-22554 * cb + half - 46802 * cr) >> sc)
        b = y + ((116130 * cb + half) >> sc)
        v[:3] = [torch.clamp(255 - t, 0, 255) for t in (r, g, b)]
    k = v[3]
    rgb = [(t * k) // 255 if adobe else ((255 - t) * (255 - k)) // 255
           for t in v[:3]]
    return torch.stack(rgb, dim=-1).to(torch.uint8)


def cmyk_to_rgb(planes, ycck: bool, adobe: bool, height: int,
                width: int) -> torch.Tensor:
    """The kernel's wrapper: uint8 (height, width, 3) from a 4-component
    frame's planes (uint8 (h, w) each); on CUDA tensors the
    `ofq_cmyk_to_rgb` kernel on the current stream (counted), on CPU
    tensors its plain version."""
    if planes[0].device.type != "cuda":
        return cmyk_to_rgb_reference(planes, ycck, adobe, height, width)
    if len(planes) != 4 or any(p.dtype != torch.uint8 or p.ndim != 2
                               or p.device != planes[0].device
                               for p in planes):
        raise ValueError("cmyk_to_rgb: four uint8 (h, w) planes on one "
                         "device")
    lib = _lib()
    dev = planes[0].device
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=dev)
    ptrs = (ctypes.c_void_p * 4)(*(p.data_ptr() for p in planes))
    ints = lambda vals: (ctypes.c_int * 4)(*vals)  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ofq_cmyk_to_rgb(
            ptrs, ints(p.stride(0) for p in planes),
            ints(p.shape[1] for p in planes), ints(p.shape[0] for p in planes),
            int(ycck), int(adobe), out.data_ptr(), width, height, stream)
    _build.check(lib, err, "cmyk_to_rgb")
    cmyk_to_rgb.launches += 1
    return out


cmyk_to_rgb.launches = 0


def jpeg_planes(data: bytes, path: str, device, info: dict) -> list:
    """nvJPEG's decode of a 4-component frame to its four planes as stored
    (uint8 (h, w) each, on the CUDA `device`, the current stream); `info`
    is `jpeg_info`'s."""
    lib = _lib()
    planes = [torch.empty(hw, dtype=torch.uint8, device=device)
              for hw in info["planes"]]
    if len(planes) != 4:
        raise DecodeError(f"{path}: {info['components']} components, not 4")
    ptrs = (ctypes.c_void_p * 4)(*(p.data_ptr() for p in planes))
    pitches = (ctypes.c_int * 4)(*(p.shape[1] for p in planes))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        st = lib.ofq_jpeg_decode_planes(_decoder(lib, device), data,
                                        len(data), ptrs, pitches, stream)
    if st != 0:
        raise DecodeError(f"{path}: nvJPEG refused the planes of a "
                          f"4-component JPEG: {_NVJPEG_STATUS.get(st, st)}")
    return planes


def decode_jpeg(data: bytes, path: str, device) -> torch.Tensor:
    """nvJPEG's wrapper: uint8 (H, W, 3) on the CUDA `device`, decoded on
    the current stream.  Counts its launches."""
    device = torch.device(device)
    if device.type != "cuda":
        raise DecodeError(f"{path}: a JPEG decodes on the card (nvJPEG); on "
                          "the CPU the port reads PNG, BMP and GIF")
    lib = _lib()
    info = jpeg_info(data, path, device)
    form = (f"{'progressive' if info['progressive'] else 'baseline'} "
            f"{info['chroma']} JPEG with {info['components']} components")
    if info["components"] == 4:
        transform = adobe_transform(data)
        planes = jpeg_planes(data, path, device, info)
        decode_jpeg.launches += 1
        return cmyk_to_rgb(planes, transform not in (None, 0),
                           transform is not None, info["height"],
                           info["width"])
    if info["components"] not in (1, 3):
        raise DecodeError(f"{path}: {form}: not decoded by the port")
    out = torch.empty((info["height"], info["width"], 3), dtype=torch.uint8,
                      device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        st = lib.ofq_jpeg_decode(_decoder(lib, device), data, len(data),
                                 out.data_ptr(), info["width"], stream)
    decode_jpeg.launches += 1
    if st != 0:
        raise DecodeError(f"{path}: nvJPEG refused the {form}: "
                          f"{_NVJPEG_STATUS.get(st, st)}")
    return out


decode_jpeg.launches = 0
