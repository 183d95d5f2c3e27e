"""Image decoding and canvas preparation of the port against the JAX
package's (``sgg_torch.data.pipeline`` and ``transforms`` against
``sgg_tpu.data``'s), on the JPEGs of a fixture tree:

* ``load_image``/``load_image_u8`` decode the same pixels;
* uint8 and float32 canvases, flipped and not, are byte-equal to JAX's
  ``prepare_example`` on its PIL path, which it takes without its native
  library; with the native library (its own triangle resize) they are
  within 1 per byte, and the share of bytes that differ is reported;
  float32 canvases agree within 1e-6 after normalization;
* ``BatchLoader`` reads the files and assembles the same batches;
* every function of ``transforms.py`` equals JAX's on seeded inputs."""

import random

import numpy as np
import pytest

import sgg_tpu.native as jnative
from sgg_tpu.data import pipeline as jpipe
from sgg_tpu.data import transforms as jtr
from sgg_tpu.data import visual_genome as jvg
from sgg_torch.data import fixtures
from sgg_torch.data import pipeline as tpipe
from sgg_torch.data import transforms as ttr
from sgg_torch.data import visual_genome as tvg

S = 128


@pytest.fixture(scope="module")
def vg(tmp_path_factory):
    root = tmp_path_factory.mktemp("vg")
    fixtures.write_vg_fixture(str(root), n_train=6, n_test=4)
    return {"jax": jvg.load_split(str(root), "train", num_val_im=0,
                                  check_sizes=False),
            "torch": tvg.load_split(str(root), "train", num_val_im=0,
                                    check_sizes=False)}


def _images(ds):
    return [f"{ds.images_dir}/{f}" for f in ds.filenames]


def test_decode_matches_jax(vg):
    for path in _images(vg["torch"]):
        np.testing.assert_array_equal(tpipe.load_image_u8(path),
                                      jpipe.load_image_u8(path))
        a, b = tpipe.load_image(path), jpipe.load_image(path)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _canvases(pipe, ds, uint8, flip):
    out = []
    for i, path in enumerate(_images(ds)):
        img = (pipe.load_image_u8 if uint8 else pipe.load_image)(path)
        rng = np.random.RandomState(i)
        out.append(pipe.prepare_example(
            img, ds.gt_boxes[i], ds.relationships[i], ds.box_coordinates,
            True, rng, im_scale=S, uint8=uint8, force_flip=flip))
    return out


@pytest.mark.parametrize("flip", [False, True], ids=["unflipped", "flipped"])
@pytest.mark.parametrize("uint8", [True, False], ids=["uint8", "float32"])
def test_canvases_equal_jax_pil_path(monkeypatch, vg, uint8, flip):
    # the JAX package's PIL path, which it takes without its native library
    monkeypatch.setattr(jnative, "prepare_image_u8", lambda *a: None)
    got = _canvases(tpipe, vg["torch"], uint8, flip)
    want = _canvases(jpipe, vg["jax"], uint8, flip)
    for (c, b, r, hw), (jc, jb, jr, jhw) in zip(got, want):
        assert c.dtype == jc.dtype and hw == jhw
        if uint8:
            np.testing.assert_array_equal(c, jc)
        else:  # normalized on the host
            np.testing.assert_allclose(c, jc, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(b, jb)
        np.testing.assert_array_equal(r, jr)
    if flip:  # the flip mirrors the content, not just the boxes
        ch, cw = got[0][3]
        plain = _canvases(tpipe, vg["torch"], uint8, False)[0][0]
        np.testing.assert_array_equal(got[0][0][:ch, :cw],
                                      plain[:ch, :cw][:, ::-1])


@pytest.mark.parametrize("flip", [False, True], ids=["unflipped", "flipped"])
def test_uint8_canvases_against_jax_as_installed(vg, flip):
    """JAX's uint8 route as it runs here: its native one-pass resize when
    its library loads (within 1 per byte), else PIL (equal bytes)."""
    got = _canvases(tpipe, vg["torch"], True, flip)
    want = _canvases(jpipe, vg["jax"], True, flip)
    diff = np.concatenate([np.abs(c[0].astype(int) - w[0].astype(int))
                           .ravel() for c, w in zip(got, want)])
    if jnative.have_native():
        assert diff.max() <= 1
        print(f"native prep: {np.mean(diff > 0):.4%} of bytes differ by 1")
    else:
        assert diff.max() == 0


@pytest.mark.parametrize("image_format", ["uint8", "float32"])
def test_batch_loader_reads_the_files(monkeypatch, vg, image_format):
    monkeypatch.setattr(jnative, "prepare_image_u8", lambda *a: None)
    kw = dict(batch_size=3, max_nodes=32, max_edges=64, im_scale=S, seed=5,
              num_workers=2, image_format=image_format)
    got = list(tpipe.BatchLoader(vg["torch"], **kw))
    want = list(jpipe.BatchLoader(vg["jax"], **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("images", "im_hw", "boxes", "classes", "node_mask", "rels",
                  "rel_mask", "im_scale_org"):
            a, b = getattr(g, k), np.asarray(getattr(w, k))
            if k == "images" and image_format == "float32":
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
        assert g.images.dtype == (np.uint8 if image_format == "uint8"
                                  else np.float32)


def test_blank_canvas_needs_no_image_library(vg, monkeypatch):
    """A file-less example (a blank image) resizes to zeros without PIL,
    as PIL resizes it."""
    import builtins
    blank = np.zeros((300, 200, 3), np.float32)
    boxes = np.asarray([[10, 10, 100, 150]], np.float32)
    want = jpipe.prepare_example(blank, boxes, np.zeros((0, 3), np.int32),
                                 "native", False, np.random.RandomState(0),
                                 im_scale=S, uint8=True)[0]
    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name.startswith("PIL"):
            raise ImportError("no PIL")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    got = tpipe.prepare_example(blank, boxes, np.zeros((0, 3), np.int32),
                                "native", False, np.random.RandomState(0),
                                im_scale=S, uint8=True)[0]
    np.testing.assert_array_equal(got, want)


def _image(seed=0, h=40, w=56):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


def test_transforms_match_jax():
    img = _image()
    boxes = np.asarray([[8, 6, 30, 25], [12, 10, 50, 35]], np.float32)
    np.testing.assert_array_equal(ttr.square_pad(img), jtr.square_pad(img))
    assert ttr.IMAGENET_MEAN_255 == jtr.IMAGENET_MEAN_255
    for rb in (True, False):
        a = ttr.random_crop(img, boxes, round_boxes=rb,
                            rng=random.Random(3))
        b = jtr.random_crop(img, boxes, round_boxes=rb,
                            rng=random.Random(3))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for f in ("adjust_brightness", "adjust_contrast", "adjust_saturation"):
        np.testing.assert_array_equal(getattr(ttr, f)(img, 1.3),
                                      getattr(jtr, f)(img, 1.3))
    np.testing.assert_array_equal(ttr.adjust_hue(img, 0.07),
                                  jtr.adjust_hue(img, 0.07))
    for x, y in zip(ttr.hflip_with_boxes(img, boxes),
                    jtr.hflip_with_boxes(img, boxes)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        ttr.color_jitter(rng=random.Random(9))(img),
        jtr.color_jitter(rng=random.Random(9))(img))
    ops = [lambda x, k=k: x * k + 0.01 for k in (0.5, 0.9, 1.1)]
    np.testing.assert_array_equal(
        ttr.RandomOrder(ops, rng=random.Random(4))(img),
        jtr.RandomOrder(ops, rng=random.Random(4))(img))
