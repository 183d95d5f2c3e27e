"""The port's uint8 image route and its device prefetch, against the JAX
package on the CPU: ``prepare_example(uint8=True)`` and
``BatchLoader(image_format="uint8")`` byte for byte (the canvas padded with
the ImageNet mean rounded to uint8), normalization on the device within
1e-6 of JAX's ``normalize_images``, the host batch a quarter of the float32
one, ``to_image_dtype``, ``device_prefetch`` keeping order and content, and
``Trainer`` handing the step the configured image format."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.data import pipeline as jpipe
from sgg_tpu.data.datasets import SGGDataset as JDataset
from sgg_tpu.data.synthetic import SyntheticSGGDataset as JSynth
from sgg_tpu.models.backbone import normalize_images as jnormalize
from sgg_torch.data import pipeline as tpipe
from sgg_torch.data.datasets import SGGDataset
from sgg_torch.data.synthetic import SyntheticSGGDataset
from sgg_torch.models.backbone import normalize_images


def _datasets(n=4, size=96, seed=3):
    kw = dict(num_images=n, num_classes=9, num_predicates=5, max_objects=5,
              image_size=size, seed=seed)
    out = []
    for synth, cls in ((JSynth(**kw), JDataset),
                       (SyntheticSGGDataset(**kw), SGGDataset)):
        out.append(cls(name="stanford", mode="train", filenames=[],
                       images_dir="", gt_boxes=synth.gt_boxes,
                       gt_classes=synth.gt_classes,
                       relationships=synth.relationships,
                       ind_to_classes=synth.ind_to_classes,
                       ind_to_predicates=synth.ind_to_predicates,
                       box_coordinates="native"))
    return out


# constant images smaller than the canvas and not square, so the mean
# padding shows: tall, wide, and one whose value rounds at .5
@pytest.mark.parametrize("hw,value,is_train", [((300, 200), 0.3, True),
                                               ((120, 400), 0.8, False),
                                               ((50, 70), 0.5 / 255, True)])
def test_uint8_canvas_equals_jax_byte_for_byte(hw, value, is_train):
    image = np.full((*hw, 3), value, np.float32)
    boxes = np.asarray([[5, 6, 40, 30], [10, 0, hw[1], hw[0]]], np.float32)
    rels = np.asarray([[0, 1, 2]], np.int32)
    outs = []
    for mod in (jpipe, tpipe):
        outs.append(mod.prepare_example(
            image, boxes, rels, "native", is_train,
            np.random.RandomState(7), im_scale=128, uint8=True))
    (jc, jb, jr, jhw), (tc, tb, tr, thw) = outs
    assert tc.dtype == np.uint8 and tc.shape == (128, 128, 3)
    assert jhw == thw and min(thw) < 128
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tr, jr)
    # the padding is the rounded mean; on the device it normalizes to
    # JAX's values within 1e-6
    np.testing.assert_array_equal(tc[-1, -1],
                                  (tpipe.IMAGENET_MEAN * 255).astype(np.uint8))
    got = normalize_images(torch.from_numpy(tc)[None]).numpy()
    want = np.asarray(jnormalize(jnp.asarray(jc)[None]))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_batch_loader_uint8_equals_jax_and_is_a_quarter():
    jds, tds = _datasets()
    kw = dict(batch_size=4, max_nodes=8, max_edges=12, shuffle=False,
              seed=0, im_scale=96)
    jb = next(iter(jpipe.BatchLoader(jds, image_format="uint8", **kw)))
    tb = next(iter(tpipe.BatchLoader(tds, image_format="uint8", **kw)))
    assert tb.images.dtype == np.uint8
    np.testing.assert_array_equal(tb.images, jb.images)
    np.testing.assert_array_equal(tb.boxes, jb.boxes)
    np.testing.assert_array_equal(tb.im_hw, jb.im_hw)
    tf = next(iter(tpipe.BatchLoader(tds, **kw)))
    assert tf.images.dtype == np.float32
    assert tb.images.nbytes * 4 == tf.images.nbytes
    # float32 canvases normalized on the host, uint8 ones on the device:
    # the same numbers where the content fills the canvas
    np.testing.assert_allclose(
        normalize_images(torch.from_numpy(tb.images)).numpy(), tf.images,
        atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        tpipe.BatchLoader(tds, image_format="png", **kw)


def test_to_image_dtype():
    _, tds = _datasets()
    kw = dict(batch_size=2, max_nodes=8, max_edges=12, shuffle=False,
              im_scale=64)
    u8 = next(iter(tpipe.BatchLoader(tds, image_format="uint8", **kw)))
    f32 = next(iter(tpipe.BatchLoader(tds, **kw)))
    assert tpipe.to_image_dtype(u8, "bfloat16") is u8
    assert tpipe.to_image_dtype(f32, "float32") is f32
    half = tpipe.to_image_dtype(f32, "bfloat16")
    assert half.images.dtype == torch.bfloat16
    torch.testing.assert_close(half.images,
                               torch.from_numpy(f32.images).bfloat16(),
                               atol=0, rtol=0)
    np.testing.assert_array_equal(half.boxes, f32.boxes)


def test_device_prefetch_keeps_order_and_content():
    _, tds = _datasets(n=8)
    loader = tpipe.BatchLoader(tds, batch_size=2, max_nodes=8, max_edges=12,
                               shuffle=False, im_scale=64,
                               image_format="uint8")
    host = list(loader)
    seen = []

    def source():
        loader._epoch = 0  # the same epoch's flips again
        for b in loader:
            seen.append(len(seen))
            yield b

    got = []
    for i, b in enumerate(tpipe.device_prefetch(source(), "cpu", size=2)):
        # the next two batches were already taken (and copied) ahead
        assert len(seen) == min(i + 3, len(host))
        got.append(b)
    assert len(got) == len(host) == 4
    for g, h in zip(got, host):
        assert isinstance(g.images, torch.Tensor)
        for field in ("images", "im_hw", "boxes", "classes", "node_mask",
                      "rels", "rel_mask"):
            np.testing.assert_array_equal(getattr(g, field).numpy(),
                                          getattr(h, field))


@pytest.mark.parametrize("image_format,compute,want", [
    ("uint8", "bfloat16", torch.uint8), ("uint8", "float32", torch.uint8),
    ("float32", "bfloat16", torch.bfloat16),
    ("float32", "float32", torch.float32)])
def test_trainer_hands_the_step_its_image_format(image_format, compute,
                                                 want):
    from sgg_torch.config import Config
    from sgg_torch.models.relhead import RelModelIMP
    from sgg_torch.train.trainer import Trainer

    _, tds = _datasets(n=4, size=64)
    cfg = Config(device="cpu", mode="sgcls", batch_size=2, max_nodes=8,
                 max_edges=12, image_format=image_format,
                 compute_dtype=compute, print_interval=10)
    model = RelModelIMP(num_classes=9, num_predicates=5, hidden_dim=16,
                        obj_dim=32)
    trainer = Trainer(cfg, {"train": tds}, model=model)
    seen = []

    def step(batch, generator):
        seen.append(batch.images)
        return {"loss": torch.zeros(())}

    trainer.train_step = step
    from sgg_torch import constants
    old = constants.IM_SCALE
    try:
        constants.IM_SCALE = 64
        trainer.train_epoch(0)
    finally:
        constants.IM_SCALE = old
    assert len(seen) == 2
    assert all(isinstance(x, torch.Tensor) and x.dtype == want
               and x.shape == (2, 64, 64, 3) for x in seen)


def test_background_keeps_order_raises_and_stops():
    """``background``: the items in order; a failure in its thread raised
    in the consumer after the items before it; closing the consumer early
    stops the thread."""
    import threading

    from sgg_torch.data.pipeline import background

    assert list(background(iter(range(7)), size=2)) == list(range(7))

    def failing():
        yield 1
        raise KeyError("in the thread")

    got = []
    with pytest.raises(KeyError, match="in the thread"):
        for x in background(failing()):
            got.append(x)
    assert got == [1]
    before = threading.active_count()
    it = background(iter(range(1000)), size=1)
    assert next(it) == 0
    it.close()
    assert threading.active_count() == before
