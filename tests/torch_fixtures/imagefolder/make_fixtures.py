"""Writes the image fixtures of this directory and, beside each, TensorFlow's
decode of it (`tf.io.decode_image(data, channels=3,
expand_animations=False)`) as an xz-compressed `.npy`
(`<file>.npy.xz`, read with `np.load(lzma.open(path))`).

    python tests/torch_fixtures/imagefolder/make_fixtures.py

Needs PIL and TensorFlow, which the port does not use.  The content is
smooth and synthetic, from a fixed seed, at sizes from ImageNet's small
end (320 x 240 and below, to keep the directory under 400 KB): JPEG
baseline 4:2:0, 4:4:4, progressive, grayscale and the 4-component forms
(CMYK under an Adobe marker, as PIL writes it; the same stream as YCCK,
its APP14 transform byte set to 2; and without the APP14 marker, which
libjpeg reads as plain CMYK); a PNG named `.JPEG` (as ImageNet's
n02105855_2933.JPEG is); a PNG; a 24-bit BMP; GIFs: plain, interlaced,
one whose first frame is smaller than its screen and has a transparent
index, and an animated one (TensorFlow decodes its first frame).  The
card's decode (`chip_smoke.py`, phase imagefolder) and the CPU tests
read them.  `python make_fixtures.py <name> ...` writes only those.
"""

import lzma
import io
import os
import struct
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))


def smooth(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    ch = []
    for _ in range(3):
        fx, fy = rng.uniform(20, 70, 2)
        ph = rng.uniform(0, 6.3)
        amp = rng.uniform(60, 110)
        ch.append(128 + amp * np.sin(x / fx + y / fy + ph))
    return np.clip(np.stack(ch, -1), 0, 255).astype(np.uint8)


def forms():
    """name -> (PIL image, save format, save options)."""
    def img(h, w, seed):
        return Image.fromarray(smooth(h, w, seed))

    return {
        "baseline_420.jpg": (img(240, 320, 0), "JPEG",
                             dict(quality=90, subsampling=2)),
        "baseline_444.jpg": (img(200, 150, 1), "JPEG",
                             dict(quality=90, subsampling=0)),
        "progressive.jpg": (img(180, 240, 2), "JPEG",
                            dict(quality=85, progressive=True)),
        "grey.jpg": (img(150, 200, 3).convert("L"), "JPEG",
                     dict(quality=90)),
        "cmyk.jpg": (img(120, 160, 4).convert("CMYK"), "JPEG",
                     dict(quality=90)),
        "n02105855_2933.JPEG": (img(90, 120, 5), "PNG", {}),
        "plain.png": (img(64, 80, 6), "PNG", {}),
        "plain.bmp": (img(48, 64, 7), "BMP", {}),
        "plain.gif": (img(60, 80, 8).quantize(64), "GIF",
                      dict(interlace=False)),
        "interlaced.gif": (img(75, 90, 9).quantize(128), "GIF",
                           dict(interlace=True)),
        "anim.gif": (img(40, 56, 10).quantize(32), "GIF",
                     dict(save_all=True, interlace=False, duration=50,
                          append_images=[img(40, 56, 11).quantize(32)])),
    }


def cmyk_with_black(h=120, w=160, seed=12):
    """A CMYK JPEG of PIL's (Adobe, inverted, 4:4:4) whose four planes all
    vary, the black one too (PIL's RGB->CMYK conversion leaves K at 0)."""
    buf = io.BytesIO()
    planes = np.concatenate([smooth(h, w, seed), smooth(h, w, seed + 1)],
                            -1)[..., :4]
    Image.fromarray(planes, "CMYK").save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _segments(data):
    """(marker, start, end) of each JPEG marker segment before the scan."""
    pos, out = 2, []
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((data[pos + 1], pos, pos + 2 + n))
        pos += 2 + n
    return out


def ycck(cmyk):
    """PIL's Adobe CMYK file with the APP14 transform byte set to 2: the
    same planes, read as YCCK."""
    b = bytearray(cmyk)
    _, start, _ = next(s for s in _segments(cmyk) if s[0] == 0xEE)
    assert bytes(b[start + 4:start + 9]) == b"Adobe"
    b[start + 15] = 2
    return bytes(b)


def no_app14(cmyk):
    """PIL's Adobe CMYK file without its APP14 marker."""
    _, start, end = next(s for s in _segments(cmyk) if s[0] == 0xEE)
    return cmyk[:start] + cmyk[end:]


def sub_frame(gif):
    """A single-frame GIF of PIL's moved onto a larger logical screen (its
    image descriptor at an offset) with a graphic control extension that
    marks colour index 0 transparent."""
    b = bytearray(gif)
    w, h, packed = struct.unpack("<HHB", b[6:11])
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
    while b[pos] == 0x21:                     # PIL's extensions, dropped
        end = pos + 2
        while b[end]:
            end += 1 + b[end]
        del b[pos:end + 1]
    assert b[pos] == 0x2C
    b[pos + 1:pos + 5] = struct.pack("<HH", 11, 7)
    b[6:10] = struct.pack("<HH", w + 20, h + 12)
    gce = bytes([0x21, 0xF9, 4, 1, 0, 0, 0, 0])
    return b"GIF89a" + bytes(b[6:pos]) + gce + bytes(b[pos:])


def _gif_parts(gif):
    """(logical screen descriptor and global table, the first image's
    descriptor, its colour table (the global one unless local), its LZW
    blocks) of a single-image GIF of PIL's."""
    w, h, packed = struct.unpack("<HHB", gif[6:11])
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
    head, table = gif[6:pos], gif[13:pos]
    while gif[pos] == 0x21:
        pos += 2
        while gif[pos]:
            pos += 1 + gif[pos]
        pos += 1
    desc = gif[pos:pos + 10]
    assert desc[0] == 0x2C and not desc[9] & 0x80
    end = pos + 11
    while gif[end]:
        end += 1 + gif[end]
    return head, desc, table, packed, gif[pos + 10:end + 1]


def growing(small, big):
    """Two frames on the larger one's screen: first the smaller GIF's image
    (its table made local, its descriptor at an offset), then the larger
    one's, whose size only the second frame has."""
    s_head, s_desc, s_table, s_packed, s_lzw = _gif_parts(small)
    b_head, b_desc, _, _, b_lzw = _gif_parts(big)
    desc = bytearray(s_desc)
    desc[1:5] = struct.pack("<HH", 5, 3)
    desc[9] = 0x80 | (s_packed & 7)
    return (b"GIF89a" + b_head + bytes(desc) + s_table + s_lzw + b_desc
            + b_lzw + b";")


# derived forms: name -> (the forms it is made from, the change)
DERIVED = {"ycck.jpg": ((), lambda: ycck(cmyk_with_black())),
           "cmyk_no_app14.jpg": ((), lambda: no_app14(cmyk_with_black())),
           "subframe_transparent.gif": (("plain.gif",), sub_frame),
           "anim_growing.gif": (("anim.gif", "plain.gif"), growing)}


def files():
    """name -> the bytes of each fixture."""
    out = {}
    for name, (im, fmt, opts) in forms().items():
        buf = io.BytesIO()
        im.save(buf, fmt, **opts)
        out[name] = buf.getvalue()
    for name, (srcs, make) in DERIVED.items():
        out[name] = make(*(out[n] for n in srcs))
    return out


def main(names=()):
    import tensorflow as tf
    tf.config.set_visible_devices([], "GPU")
    for name, data in files().items():
        if names and name not in names:
            continue
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        ref = tf.io.decode_image(data, channels=3,
                                 expand_animations=False).numpy()
        with lzma.open(path + ".npy.xz", "wb", preset=9) as f:
            np.save(f, ref)
        print(name, ref.shape, len(data), os.path.getsize(path + ".npy.xz"))


if __name__ == "__main__":
    main(sys.argv[1:])
