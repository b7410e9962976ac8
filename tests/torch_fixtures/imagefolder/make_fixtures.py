"""Writes the image fixtures of this directory and, beside each, TensorFlow's
decode of it (`tf.io.decode_image(data, channels=3,
expand_animations=False)`) as an xz-compressed `.npy`
(`<file>.npy.xz`, read with `np.load(lzma.open(path))`).

    python tests/torch_fixtures/imagefolder/make_fixtures.py

Needs PIL and TensorFlow, which the port does not use.  The content is
smooth and synthetic, from a fixed seed, at sizes from ImageNet's small
end (320 x 240 and below, to keep the directory near 300 KB): JPEG
baseline 4:2:0, 4:4:4, progressive, grayscale and CMYK (Adobe, as PIL
writes it); a PNG named `.JPEG` (as ImageNet's n02105855_2933.JPEG is);
a PNG; a 24-bit BMP.  The card's decode (`chip_smoke.py`, phase
imagefolder) and the CPU tests read them.
"""

import lzma
import io
import os

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
    }


def main():
    import tensorflow as tf
    tf.config.set_visible_devices([], "GPU")
    for name, (im, fmt, opts) in forms().items():
        buf = io.BytesIO()
        im.save(buf, fmt, **opts)
        data = buf.getvalue()
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        ref = tf.io.decode_image(data, channels=3,
                                 expand_animations=False).numpy()
        with lzma.open(path + ".npy.xz", "wb", preset=9) as f:
            np.save(f, ref)
        print(name, ref.shape, len(data), os.path.getsize(path + ".npy.xz"))


if __name__ == "__main__":
    main()
