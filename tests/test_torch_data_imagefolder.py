"""The port's ImageFolder pipeline (`ofq_tpu_torch.data`, `device="cpu"`)
against the JAX package's tf.data pipeline (`ofq_tpu.data`) on this CPU.

The ImageFolders are PNGs written from a numpy seed at 37 x 53, 64 x 80
and 200 x 300.  In `folder` each file is one uniform colour that encodes its
index (R = 8 * (i % 32), G = 8 * (i // 32), B = 128), so it is recognised
after any crop, resize and flip (a resize of a uniform image moves it by
less than one level; the code is read back to the nearest multiple of 8).

  * the listing (the `val` fallback), the host partition and the -1
    padding of the eval shards equal JAX's for shard_count 1, 2, 3;
  * one train epoch covers each file once, or `num_aug_repeats` times in
    a row; train batches are full, the eval stream keeps the remainder;
  * the resize against `tf.image.resize` (bicubic and bilinear, up and
    down, 6 shape pairs): within 1e-3 in fp32;
  * the eval stream against JAX's `make_dataset(train=False)` batch for
    batch on random images, at img_size 32 and 224: exact, but where TF's
    value before rounding lies within 1e-3 of a rounding edge a pixel may
    differ by one level, 1 / (255 std) after normalization, on at most
    0.1 % of the pixels;
  * the RRC parameters against JAX's `rrc_crop_params` by a two-sample KS
    test (1000 draws each, fixed seeds on both sides) at three image
    shapes, one of which forces the fallback;
  * decoding: PNG (every colour type, 1- and 16-bit, Adam7) and BMP (24,
    32 bit)
    against `tf.io.decode_image(channels=3)` exactly; the checked-in
    fixtures' PNG and BMP forms (`torch_fixtures/imagefolder`) against
    TF's decode stored beside them, and TF's decode of every fixture against
    that stored copy (GIF among them); a JPEG on the CPU, an unknown form
    and a GIF cut short raise, naming the file;
  * `cli.train.main(..., device="cpu")` for one short epoch on a PNG
    ImageFolder with `deit_test_distilled`; the runner's evaluation counts
    exclude the -1 sentinels of a padded shard.
"""

import dataclasses
import io
import lzma
from pathlib import Path

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
tf.config.set_visible_devices([], "GPU")

from PIL import Image  # noqa: E402
from scipy import stats  # noqa: E402

from ofq_tpu.data import pipeline as jpipeline  # noqa: E402
from ofq_tpu_torch.data import decode, pipeline  # noqa: E402
from ofq_tpu_torch.data.resize import resize  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures" / "imagefolder"
SHAPES = ((37, 53), (64, 80), (200, 300))
CPU = torch.device("cpu")


def _code_colour(i):
    return np.array([8 * (i % 32), 8 * (i // 32), 128], np.uint8)


def _write(path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path, format="PNG")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """train: 3 classes of 4, 3, 4 files; `val` (no `validation`): 2
    classes of 3 and 2 files; uniform colours coding the listing index."""
    root = tmp_path_factory.mktemp("coded")
    i = 0
    for split, counts in (("train", (4, 3, 4)), ("val", (3, 2))):
        for c, n in enumerate(counts):
            for k in range(n):
                h, w = SHAPES[i % 3]
                img = np.broadcast_to(_code_colour(i), (h, w, 3)).copy()
                _write(root / split / f"n{c:02d}" / f"img{k}.png", img)
                i += 1
    return str(root)


@pytest.fixture(scope="module")
def noisy(tmp_path_factory):
    """Random-content PNGs: 2 classes x 3 files in train and validation."""
    root = tmp_path_factory.mktemp("noisy")
    rng = np.random.default_rng(0)
    i = 0
    for split in ("train", "validation"):
        for c in range(2):
            for k in range(3):
                h, w = SHAPES[i % 3]
                _write(root / split / f"c{c}" / f"img{k}.png",
                       rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
                i += 1
    return str(root)


def _codes(images, cfg):
    """The index coded in each (uniform) image of a normalized batch."""
    img = np.asarray(images, np.float64)
    px = img * (np.asarray(cfg.std) * 255) + np.asarray(cfg.mean) * 255
    mid = px[:, px.shape[1] // 2, px.shape[2] // 2]
    r, g = np.rint(mid[:, 0] / 8).astype(int), np.rint(mid[:, 1] / 8)
    return list(r + 32 * g.astype(int))


def _cpu(batch):
    return {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in batch.items()}


def _port_eval(cfg):
    return [_cpu(b) for b in pipeline.make_dataset(cfg, train=False,
                                                   device=CPU)]


def _jax_eval(cfg):
    return list(jpipeline.make_dataset(cfg, train=False))


@pytest.mark.parametrize("split", ["train", "validation"])
def test_listing_matches_jax(folder, split):
    got = pipeline._list_imagefolder(folder, split)
    want = jpipeline._list_imagefolder(folder, split)
    assert got == want
    assert pipeline.num_samples(pipeline.DataConfig(data_dir=folder),
                                train=split == "train") == len(want[0])


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2), (0, 3), (1, 3),
                                   (2, 3)])
def test_host_partition_and_padding_match_jax(folder, shard):
    """Eval: the files and labels of each host's stream (the -1 padding
    included) are JAX's, in JAX's order.  Train: the host's files are the
    ones JAX's first epoch draws."""
    idx, count = shard
    cfg = pipeline.DataConfig(data_dir=folder, img_size=16, batch_size=2,
                              num_classes=3, aa=None, reprob=0.0,
                              shard_index=idx, shard_count=count)
    jcfg = jpipeline.DataConfig(**dataclasses.asdict(cfg))
    got, want = _port_eval(cfg), _jax_eval(jcfg)
    assert [len(b["label"]) for b in got] == [len(b["label"]) for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["label"], w["label"])
        assert _codes(g["image"], cfg) == _codes(w["image"], cfg)
    files, labels = pipeline.host_files(cfg, train=False)
    all_files, _, _ = jpipeline._list_imagefolder(folder, "validation")
    assert [all_files.index(f) + 11 for f in files] == [
        c for b in got for c in _codes(b["image"], cfg)]
    assert labels == [int(v) for b in want for v in b["label"]]
    # train: the same partition (JAX's epoch is a shuffle of it)
    tfiles, _ = pipeline.host_files(cfg, train=True)
    n = len(tfiles)
    jit = jpipeline.make_dataset(
        dataclasses.replace(jcfg, batch_size=1), train=True)
    seen = sorted(_codes(next(jit)["image"], cfg)[0] for _ in range(n))
    train_all, _, _ = jpipeline._list_imagefolder(folder, "train")
    assert seen == sorted(train_all.index(f) for f in tfiles)


@pytest.mark.parametrize("reps", [0, 2])
def test_train_epoch_covers_each_file(folder, reps):
    cfg = pipeline.DataConfig(data_dir=folder, img_size=16, batch_size=3,
                              num_classes=3, aa=None, reprob=0.0,
                              num_aug_repeats=reps)
    n = 11 * max(reps, 1)
    stream = pipeline.make_dataset(cfg, train=True, device=CPU)
    codes, labels = [], []
    while len(codes) < 2 * n:
        b = _cpu(next(stream))
        assert b["image"].shape == (3, 16, 16, 3)
        codes += _codes(b["image"], cfg)
        labels += list(b["label"])
    files, flabels, _ = jpipeline._list_imagefolder(folder, "train")
    for epoch in (codes[:n], codes[n:2 * n]):
        if reps:
            assert all(epoch[k] == epoch[k + 1] for k in range(0, n, 2))
            epoch = epoch[::2]
        assert sorted(epoch) == list(range(11))
    assert codes[:n] != codes[n:2 * n]
    assert labels[:n] == [flabels[c] for c in codes[:n]]


@pytest.mark.parametrize("train", [True, False])
def test_remainder(folder, train):
    """11 train files and 5 eval files at B=4: the train stream drops no
    item and yields only full batches; the eval stream ends 4, 1."""
    cfg = pipeline.DataConfig(data_dir=folder, img_size=16, batch_size=4,
                              num_classes=3, aa=None, reprob=0.0)
    it = pipeline.make_dataset(cfg, train=train, device=CPU)
    if train:
        sizes = [len(next(it)["label"]) for _ in range(5)]
        assert sizes == [4] * 5
    else:
        assert [len(b["label"]) for b in it] == [4, 1]


RESIZE_CASES = [((37, 53), (224, 224)), ((37, 53), (20, 31)),
                ((200, 300), (32, 32)), ((64, 80), (129, 27)),
                ((64, 80), (64, 80)), ((200, 300), (248, 372))]


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("shapes", RESIZE_CASES)
def test_resize_matches_tf(shapes, method):
    (h, w), size = shapes
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)
    want = tf.image.resize(img, size, method=method).numpy()
    got = resize(torch.from_numpy(img), size, method)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("img_size", [32, 224])
def test_eval_stream_matches_jax(noisy, img_size):
    cfg = pipeline.DataConfig(data_dir=noisy, img_size=img_size,
                              batch_size=4, num_classes=2)
    got = _port_eval(cfg)
    want = _jax_eval(jpipeline.DataConfig(**dataclasses.asdict(cfg)))
    assert len(got) == len(want) == 2
    level = 1.0 / (255.0 * min(cfg.std)) + 1e-5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["label"], w["label"])
        assert g["image"].shape == w["image"].shape
        diff = np.abs(g["image"] - w["image"])
        # fp32 normalization of equal pixels agrees to the last ulp
        off = diff > 1e-5
        assert diff.max() <= level, diff.max()
        assert off.mean() <= 1e-3, off.mean()


# h, w, scale; the last forces the centre-crop fallback on most draws
RRC_CASES = [(300, 400, (0.08, 1.0)), (224, 224, (0.08, 1.0)),
             (20, 600, (0.08, 1.0))]
N_DRAWS = 1000


@pytest.mark.parametrize("case", RRC_CASES)
def test_rrc_params_ks(case):
    h, w, scale = case
    tf.random.set_seed(1234)
    fn = tf.function(lambda: jpipeline.rrc_crop_params(
        tf, tf.constant(h), tf.constant(w), scale))
    want = np.array([[int(v) for v in fn()] for _ in range(N_DRAWS)])
    gen = torch.Generator().manual_seed(99)
    u = torch.rand((N_DRAWS, pipeline.RRC_UNIFORMS), generator=gen,
                   dtype=torch.float64).numpy()
    got = np.array([pipeline.rrc_crop_params(r, h, w, scale) for r in u])
    assert (got[:, 0] >= 0).all() and (got[:, 0] + got[:, 2] <= h).all()
    assert (got[:, 1] >= 0).all() and (got[:, 1] + got[:, 3] <= w).all()
    for col in range(4):
        res = stats.ks_2samp(got[:, col], want[:, col])
        assert res.pvalue > 1e-3, (case, col, res)
    if h == 20:
        # the fallback box is torchvision's: h, round(h * 4/3), centred
        fb = (h, round(h * 4 / 3))
        share = lambda a: np.mean([tuple(r[2:]) == fb for r in a])  # noqa
        assert share(got) > 0.5 and abs(share(got) - share(want)) < 0.05
        assert all(tuple(r[:2]) == (0, (w - fb[1]) // 2)
                   for r in got if tuple(r[2:]) == fb)


def _adam7_png(rgb):
    """An interlaced (Adam7) 8-bit RGB PNG, every row unfiltered."""
    import struct
    import zlib
    h, w, _ = rgb.shape
    rows = b""
    for r0, c0, dr, dc in decode._ADAM7:
        sub = rgb[r0::dr, c0::dc]
        if sub.size:
            rows += b"".join(b"\x00" + r.tobytes() for r in sub)

    def chunk(kind, body):
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", crc)

    return (decode.PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _png_forms():
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    out = {}
    for mode in ("RGB", "RGBA", "L", "LA", "P", "1"):
        buf = io.BytesIO()
        Image.fromarray(rgb).convert(mode).save(buf, "PNG")
        out[f"png-{mode}"] = buf.getvalue()
    a16 = rng.integers(0, 65536, (21, 17, 4), dtype=np.uint16)
    out["png-16bit-rgba"] = tf.io.encode_png(a16).numpy()
    out["png-16bit-grey"] = tf.io.encode_png(a16[..., :1]).numpy()
    out["png-adam7"] = _adam7_png(rgb)
    for mode in ("RGB", "RGBA"):
        buf = io.BytesIO()
        Image.fromarray(np.concatenate([rgb, rgb[..., :1]], -1),
                        "RGBA").convert(mode).save(buf, "BMP")
        out[f"bmp-{mode}"] = buf.getvalue()
    return out


def _fixture_files():
    if not FIXTURES.is_dir():
        return []
    return sorted(p.name for p in FIXTURES.iterdir()
                  if p.suffix not in (".xz", ".py"))


@pytest.mark.parametrize("form", sorted(_png_forms()) + [
    f"fixture:{n}" for n in _fixture_files()])
def test_decode_matches_tf(form):
    if form.startswith("fixture:"):
        path = FIXTURES / form.split(":", 1)[1]
        data = path.read_bytes()
        with lzma.open(str(path) + ".npy.xz") as f:
            want = np.load(f)
        np.testing.assert_array_equal(want, tf.io.decode_image(
            data, channels=3, expand_animations=False).numpy())
        if decode.image_form(data) == "jpeg":
            with pytest.raises(decode.DecodeError, match=path.name):
                decode.decode_image(data, str(path), CPU)
            return
    else:
        data = _png_forms()[form]
        path = form
        want = tf.io.decode_image(data, channels=3,
                                  expand_animations=False).numpy()
    got = decode.decode_image(data, str(path), CPU)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_refusals(tmp_path):
    jpeg = tf.io.encode_jpeg(np.zeros((8, 8, 3), np.uint8)).numpy()
    with pytest.raises(decode.DecodeError, match="a.JPEG.*on the card"):
        decode.decode_image(jpeg, str(tmp_path / "a.JPEG"), CPU)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, "GIF")
    gif = buf.getvalue()
    with pytest.raises(decode.DecodeError, match="b.png: GIF"):
        decode.decode_image(gif[:len(gif) // 2], str(tmp_path / "b.png"),
                            CPU)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, "TIFF")
    with pytest.raises(decode.DecodeError, match="c.png: an unknown form"):
        decode.decode_image(buf.getvalue(), str(tmp_path / "c.png"), CPU)
    # a JPEG inside a train stream on the CPU raises there, named
    root = tmp_path / "jf"
    (root / "train" / "c").mkdir(parents=True)
    (root / "train" / "c" / "x.png").write_bytes(jpeg)
    cfg = pipeline.DataConfig(data_dir=str(root), img_size=8, batch_size=1)
    with pytest.raises(decode.DecodeError, match="x.png"):
        next(pipeline.make_dataset(cfg, train=True, device=CPU))


CLI = ["--model", "deit_test_distilled", "--img-size", "32",
       "--num-classes", "3", "--batch-size", "4", "--steps-per-epoch", "2",
       "--epochs", "1", "--warmup-epochs", "0", "--cooldown-epochs", "0",
       "--mixup", "0", "--cutmix", "0", "--wq-enable", "--aq-enable",
       "--wq-bitw", "2", "--aq-bitw", "2", "--wq-per-channel",
       "--aq-per-channel", "--wq-mode", "statsq", "--quantized",
       "--qk_reparam", "--qk_reparam_type", "0", "--log-interval", "1"]


def test_cli_train_on_imagefolder(folder, tmp_path):
    from ofq_tpu_torch.cli import common, runner
    from ofq_tpu_torch.cli import train as port_train
    from ofq_tpu_torch.train import make_eval_step

    best = port_train.main([folder, *CLI, "--output", str(tmp_path),
                            "--experiment", "e"], device="cpu")
    assert best["epoch"] == 0 and 0.0 <= best["top1"] <= 100.0
    assert (tmp_path / "e" / "summary.csv").exists()
    # a padded shard: 5 eval files over 2 hosts, host 1 holds the pad
    r = runner.Runner(common.parse_args([folder, *CLI]), device="cpu")
    r.data_cfg = dataclasses.replace(r.data_cfg, shard_index=1,
                                     shard_count=2)
    first = next(iter(r._dataset(r.data_cfg, train=False)))
    r.calibrate_init(first)
    step = make_eval_step(r.model)
    seen = []

    def spy(params, batch):
        out = step(params, batch)
        seen.append((int(out["count"]), batch["label"].tolist()))
        return out

    r.evaluate(spy, None)
    labels = [v for _, b in seen for v in b]
    assert labels.count(-1) == 1 and len(labels) == 3
    assert sum(c for c, _ in seen) == 2
