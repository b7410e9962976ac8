"""The input's 4-component JPEGs and GIFs (`ofq_tpu_torch.data.decode`) on
the CPU, against TensorFlow's decode, which the JAX package's input calls
(`tf.io.decode_image(channels=3, expand_animations=False)`).

  * the conversion of a 4-component frame (`cmyk_to_rgb_reference`, the
    plain version of the card's `ofq_cmyk_to_rgb` kernel): on the planes
    PIL's libjpeg decodes from each fixture (Adobe CMYK, YCCK, CMYK without
    APP14), the RGB TensorFlow's libjpeg gives with the same IDCT
    (`dct_method="INTEGER_ACCURATE"`, PIL's), exactly.  The fixtures' stored
    decode (`.npy.xz`, TensorFlow's default IDCT) is at most 3 levels from
    it: the card's nvJPEG IDCT is held to `chip_smoke.JPEG_GATE` there;
  * the Adobe APP14 transform byte as libjpeg reads it;
  * GIF (`decode_gif`): PIL-written GIFs of random colours (LZW tables
    that fill to 4096 codes, interlaced and not) and the fixtures, each
    equal to TensorFlow's decode; the fixtures exercise the transparent
    index, a first frame smaller than its screen and an animation whose
    later frame is the larger; a GIF cut inside its data raises, naming
    the file.
"""

import io
import lzma
from pathlib import Path

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
tf.config.set_visible_devices([], "GPU")

from PIL import Image  # noqa: E402

from ofq_tpu_torch.data import decode  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "imagefolder"
# fixture -> (the fixture whose PIL decode gives its planes, the Adobe
# transform byte): the YCCK file is the no-APP14 file's stream under
# another marker, and PIL's YCCK decode is already converted
FOUR = {"cmyk.jpg": ("cmyk.jpg", 0),
        "ycck.jpg": ("cmyk_no_app14.jpg", 2),
        "cmyk_no_app14.jpg": ("cmyk_no_app14.jpg", None)}
GIFS = ("plain.gif", "interlaced.gif", "anim.gif", "anim_growing.gif",
        "subframe_transparent.gif")


def _planes(name):
    """The four planes libjpeg decodes (PIL inverts every CMYK JPEG)."""
    raw = 255 - np.asarray(Image.open(FIXTURES / name))
    return [torch.from_numpy(np.ascontiguousarray(raw[..., c]))
            for c in range(4)]


def _stored(name):
    with lzma.open(str(FIXTURES / name) + ".npy.xz") as f:
        return np.load(f)


@pytest.mark.parametrize("name", sorted(FOUR))
def test_four_component_conversion_is_tfs(name):
    src, transform = FOUR[name]
    data = (FIXTURES / name).read_bytes()
    assert decode.adobe_transform(data) == transform
    want = tf.io.decode_jpeg(data, channels=3,
                             dct_method="INTEGER_ACCURATE").numpy()
    assert want.std() > 10          # every plane varies: no trivial K
    got = decode.cmyk_to_rgb(_planes(src), transform not in (None, 0),
                             transform is not None, *want.shape[:2])
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    stored = _stored(name).astype(np.int64)
    assert np.abs(stored - want).max() <= 3


def test_four_component_planes_are_read_at_their_sampled_size():
    """A plane of half the width and height is read at floor(x w / W),
    floor(y h / H): each of its pixels covers a 2 x 2 block."""
    g = torch.Generator().manual_seed(0)
    full = [torch.randint(0, 256, (6, 8), generator=g, dtype=torch.uint8)
            for _ in range(4)]
    half = [p[::2, ::2].contiguous() for p in full]
    up = [p.repeat_interleave(2, 0).repeat_interleave(2, 1) for p in half]
    for ycck in (False, True):
        mixed = [full[0], half[1], half[2], full[3]]
        want = decode.cmyk_to_rgb_reference(
            [full[0], up[1], up[2], full[3]], ycck, True, 6, 8)
        assert torch.equal(decode.cmyk_to_rgb_reference(mixed, ycck, True,
                                                        6, 8), want)


def _random_gif(h, w, colours, interlace, seed):
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.quantize(colours).save(buf, "GIF", interlace=interlace)
    return buf.getvalue()


@pytest.mark.parametrize("form", [f"fixture:{n}" for n in GIFS] + [
    "random:256:plain", "random:256:interlaced", "random:5:plain"])
def test_gif_is_tfs(form):
    kind, *rest = form.split(":")
    if kind == "fixture":
        data = (FIXTURES / rest[0]).read_bytes()
    else:
        data = _random_gif(97, 131, int(rest[0]), rest[1] == "interlaced",
                           int(rest[0]))
    want = tf.io.decode_image(data, channels=3,
                              expand_animations=False).numpy()
    got = decode.decode_image(data, form, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gif_fixtures_exercise_their_rules():
    """The transparent index occurs inside the sub-frame fixture's image
    and its colour is not black; the sub-frame's canvas is its frame's
    size, not its larger screen; the growing animation's canvas is its
    second frame's size."""
    data = (FIXTURES / "subframe_transparent.gif").read_bytes()
    w, h = np.frombuffer(data[6:10], "<u2")
    got = decode.decode_gif(data, "subframe_transparent.gif")
    assert (w, h) == (100, 72) and got.shape == (60, 80, 3)
    plain = decode.decode_gif((FIXTURES / "plain.gif").read_bytes(), "p")
    # the same frame at (top 7, left 11), index 0 black where it shows
    inner = got[7:, 11:]
    black = (inner == 0).all(-1) & ~(plain[:53, :69] == 0).all(-1)
    assert black.sum() > 10
    assert np.array_equal(inner[~black], plain[:53, :69][~black])
    assert (got[:7] == 0).all() and (got[:, :11] == 0).all()
    grow = decode.decode_gif((FIXTURES / "anim_growing.gif").read_bytes(),
                             "g")
    first = decode.decode_gif((FIXTURES / "anim.gif").read_bytes(), "a")
    assert grow.shape == (60, 80, 3)
    assert np.array_equal(grow[3:43, 5:61], first)


def test_malformed_gif_raises_naming_the_file():
    data = (FIXTURES / "interlaced.gif").read_bytes()
    for cut in (12, 40, len(data) // 2):
        with pytest.raises(decode.DecodeError, match="bad.gif: GIF"):
            decode.decode_image(data[:cut], "x/bad.gif", torch.device("cpu"))
