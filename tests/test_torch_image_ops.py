"""The port's native image preprocessing (``cmh_torch/native/image_ops``)
against cmh_tpu's native library and PIL, and the transforms that use it."""

import numpy as np
import pytest
from PIL import Image

import torch_threads  # noqa: F401  (before any torch work)
from cmh_torch.data import transforms
from cmh_torch.native import _build, image_ops
from cmh_tpu import native as jax_native
from cmh_tpu.data import transforms as jax_transforms

MEAN, STD = transforms.CLIP_MEAN, transforms.CLIP_STD


def _img(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, size=(h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_lib():
    assert jax_native.available(), "cmh_tpu's native library did not build"


# (source h, w, output size, box (y, x, h, w) or None for the whole image,
# mode, flip): down- and up-scaling, both filters, flips, odd sizes
CASES = [
    (48, 64, 32, None, image_ops.BICUBIC, False),
    (48, 64, 32, None, image_ops.BILINEAR, False),
    (16, 16, 32, None, image_ops.BILINEAR, False),
    (16, 16, 33, None, image_ops.BICUBIC, False),
    (375, 500, 224, None, image_ops.BICUBIC, False),
    (37, 53, 24, None, image_ops.BICUBIC, True),
    (40, 50, 16, (5, 7, 20, 30), image_ops.BILINEAR, False),
    (40, 50, 17, (5, 7, 20, 30), image_ops.BILINEAR, True),
    (101, 77, 224, (3, 11, 97, 61), image_ops.BILINEAR, True),
    (9, 7, 5, (1, 2, 7, 5), image_ops.BICUBIC, True),
    (300, 200, 224, (0, 0, 300, 200), image_ops.BILINEAR, False),
]


@pytest.mark.parametrize("h,w,size,box,mode,flip", CASES)
def test_bit_equal_to_cmh_tpu_native_and_pil(jax_lib, h, w, size, box, mode, flip):
    arr = _img(h, w, seed=h * w + size)
    box = box or (0, 0, h, w)
    got = image_ops.crop_resize_normalize(arr, box, size, mode, MEAN, STD, flip)
    want = jax_native.crop_resize_normalize(arr, box, size, mode, MEAN, STD, flip)
    assert got.shape == (size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # PIL on the flipped image, the box in its coordinates
    src = Image.fromarray(np.ascontiguousarray(arr[:, ::-1] if flip else arr))
    y, x, bh, bw = box
    pil = src.resize((size, size), Image.BICUBIC if mode == image_ops.BICUBIC else Image.BILINEAR,
                     box=(x, y, x + bw, y + bh))
    np.testing.assert_array_equal(got, transforms.normalize(np.asarray(pil)))


def test_resize_normalize_is_the_whole_box():
    arr = _img(31, 45, seed=2)
    np.testing.assert_array_equal(
        image_ops.resize_normalize(arr, 20, image_ops.BILINEAR, MEAN, STD, flip=True),
        image_ops.crop_resize_normalize(arr, (0, 0, 31, 45), 20, image_ops.BILINEAR, MEAN,
                                        STD, flip=True))


@pytest.mark.parametrize("shape,size", [((375, 500, 3), 224), ((40, 52, 3), 32),
                                        ((17, 300, 3), 32)])
def test_transforms_equal_cmh_tpu_native_path(jax_lib, shape, size):
    rng = np.random.RandomState(sum(shape) + size)
    img = Image.fromarray(rng.randint(0, 256, shape, dtype=np.uint8))
    for seed in range(6):   # both flip draws among them
        got = transforms.train_transform(img, size, np.random.RandomState(seed))
        np.testing.assert_array_equal(
            got, jax_transforms.train_transform(img, size, np.random.RandomState(seed)))
        plain = transforms.train_transform_plain(img, size, np.random.RandomState(seed))
        assert np.percentile(np.abs(got - plain) * STD, 99) < 2.0 / 255
    got = transforms.eval_transform(img, size)
    np.testing.assert_array_equal(got, jax_transforms.eval_transform(img, size))
    assert np.percentile(np.abs(got - transforms.eval_transform_plain(img, size)) * STD,
                         99) < 2.0 / 255


def test_train_transform_draws_as_plain():
    """The native and PIL train transforms leave the RandomState where
    cmh_tpu's does: a resume replays the same draws."""
    img = Image.fromarray(_img(60, 90, seed=9))
    a, b = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(5):
        transforms.train_transform(img, 32, a)
        transforms.train_transform_plain(img, 32, b)
    assert a.rand() == b.rand()


def test_grey_and_rgba_images_are_read_as_rgb():
    rgb = _img(20, 30, seed=5)
    for mode in ("L", "RGBA"):
        img = Image.fromarray(rgb).convert(mode)
        np.testing.assert_array_equal(transforms.eval_transform(img, 16),
                                      transforms.eval_transform(img.convert("RGB"), 16))


@pytest.mark.parametrize("bad", [
    dict(src=np.zeros((4, 4), np.uint8)),
    dict(src=np.zeros((4, 4, 3), np.float32)),
    dict(box=(0, 0, 5, 4)),
    dict(box=(-1, 0, 2, 2)),
    dict(box=(0, 0, 0, 2)),
    dict(mode=2),
    dict(size=0),
])
def test_bad_arguments_raise(bad):
    args = dict(src=np.zeros((4, 4, 3), np.uint8), box=(0, 0, 4, 4), size=2,
                mode=image_ops.BILINEAR)
    args.update(bad)
    with pytest.raises(ValueError):
        image_ops.crop_resize_normalize(args["src"], args["box"], args["size"], args["mode"],
                                        MEAN, STD)


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS + ["-fno-such-flag"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for image_ops.cpp"):
        _build.build("image_ops")


def test_failed_self_test_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="failed its self-test"):
        _build.load("image_ops", image_ops._configure, lambda lib: False)
    assert image_ops._self_test(_build.load("image_ops", image_ops._configure,
                                            image_ops._self_test))
