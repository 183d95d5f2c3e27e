"""The port's native host library (``sgg_torch.native``) against the JAX
package's (``sgg_tpu.native``) and against its own plain numpy versions,
on the CPU:

* ``prepare_image_u8`` byte-equal to JAX's, flipped and not, from a 1 px
  strip to 768 x 1024; its plain version within 1 per byte (``g++`` fuses
  the C++'s multiply-adds);
* ``pack_graph_batch`` the same buffers and dropped count as JAX's and as
  its plain version, with cut nodes, relations past the caps, negative
  indices, an image with no relations and an empty batch;
* ``draw_union_rects_native`` byte-equal to JAX's and to its plain
  version, and the port's torch rasterizer within 1e-4 of it;
* a build that fails raises with the compiler's command and output, and
  no caller falls back to PIL or numpy; builds share one library across
  processes through a lock file and a rename.

Where JAX's library failed to build in this process, its sources are
compiled here with its Makefile's flags (``torch_native_common``)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from sgg_torch import native
from sgg_torch.data import pipeline as tpipe
from sgg_torch.data.pipeline import content_size
from sgg_torch.ops.rects import draw_union_rects
from torch_native_common import jax_library, jax_native, makefile_flags

S = 592
MEAN_U8 = (tpipe.IMAGENET_MEAN * 255).astype(np.uint8)
SIZES = [(768, 1024), (600, 800), (600, 400), (592, 592), (300, 500),
         (1, 700)]


@pytest.fixture(scope="module")
def jax(tmp_path_factory):
    return jax_native(tmp_path_factory.mktemp("jax_native"))


def _image(hw, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (*hw, 3), np.uint8)


def _prep(fn, img, flip):
    ch, cw, _ = content_size(*img.shape[:2], S)
    return fn(img, S, ch, cw, flip, MEAN_U8)


@pytest.mark.parametrize("flip", [False, True], ids=["unflipped", "flipped"])
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_prepare_image_u8_equals_jax(jax, hw, flip):
    img = _image(hw)
    got = _prep(native.prepare_image_u8, img, flip)
    want = _prep(jax.prepare_image_u8, img, flip)
    assert got.dtype == np.uint8 and got.shape == (S, S, 3)
    np.testing.assert_array_equal(got, want)
    ch, cw, _ = content_size(*hw, S)
    assert (got[ch:] == MEAN_U8).all() and (got[:, cw:] == MEAN_U8).all()


@pytest.mark.parametrize("flip", [False, True], ids=["unflipped", "flipped"])
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_prepare_image_u8_plain_within_one(hw, flip):
    img = _image(hw, seed=1)
    got = _prep(native.prepare_image_u8, img, flip)
    plain = _prep(native.prepare_image_u8_plain, img, flip)
    diff = np.abs(got.astype(int) - plain.astype(int))
    assert diff.max() <= 1
    assert np.mean(diff > 0) <= 1e-4


def test_prepare_image_u8_flip_mirrors_the_content():
    img = _image((300, 500), seed=2)
    ch, cw, _ = content_size(300, 500, S)
    plain = _prep(native.prepare_image_u8, img, False)
    flipped = _prep(native.prepare_image_u8, img, True)
    np.testing.assert_array_equal(flipped[:ch, :cw],
                                  plain[:ch, :cw][:, ::-1])


@pytest.mark.parametrize("bad", ["float", "gray", "too_big"])
def test_prepare_image_u8_refuses_bad_inputs(bad):
    img = _image((40, 60))
    ch, cw = 20, 30
    if bad == "float":
        img = img.astype(np.float32)
    elif bad == "gray":
        img = img[..., 0]
    else:
        ch = S + 1
    for fn in (native.prepare_image_u8, native.prepare_image_u8_plain):
        with pytest.raises(ValueError):
            fn(img, S, ch, cw, False, MEAN_U8)


def _ragged(seed, counts, rel_counts, n_classes=20):
    """Concatenated graphs: ``counts`` nodes and ``rel_counts`` relations
    an image, relation ends drawn from [-2, nodes + 2) so that some point
    at cut, missing or negative nodes."""
    rng = np.random.RandomState(seed)
    n_all = sum(counts)
    boxes = (rng.rand(n_all, 4) * 500).astype(np.float32)
    classes = rng.randint(1, n_classes, n_all).astype(np.int32)
    rels = [np.stack([rng.randint(-2, n + 2, r), rng.randint(-2, n + 2, r),
                      rng.randint(1, 50, r)], 1)
            for n, r in zip(counts, rel_counts)]
    rels = (np.concatenate(rels).astype(np.int32) if sum(rel_counts)
            else np.zeros((0, 3), np.int32))
    node_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    rel_offsets = np.concatenate([[0], np.cumsum(rel_counts)]).astype(
        np.int64)
    return boxes, classes, node_offsets, rels, rel_offsets


PACK_CASES = {
    # image 0 has more nodes than n_max and more relations than e_max
    "overflow": (0, [60, 10, 40, 5], [900, 30, 300, 0], 40, 256),
    "no_relations": (1, [12, 7], [0, 0], 40, 256),
    "empty_images": (2, [0, 9, 0], [0, 20, 3], 16, 32),
    "empty_batch": (3, [], [], 40, 256),
    "small_caps": (4, [30, 30, 30], [90, 90, 90], 8, 4),
}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_graph_batch_equals_jax_and_plain(jax, case):
    seed, counts, rel_counts, n_max, e_max = PACK_CASES[case]
    args = (*_ragged(seed, counts, rel_counts), n_max, e_max)
    got = native.pack_graph_batch(*args)
    for other in (jax.pack_graph_batch(*args),
                  native.pack_graph_batch_plain(*args)):
        assert len(other) == len(got) == 6
        for g, w in zip(got[:5], other[:5]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert got[5] == other[5]
    B = len(counts)
    assert got[0].shape == (B, n_max, 4) and got[3].shape == (B, e_max, 3)
    # every relation is either kept or counted as dropped
    assert int(got[4].sum()) + got[5] == sum(rel_counts)
    if case == "overflow":
        assert got[5] > 0 and got[4][0].all() and got[2][0].all()


def test_pack_graph_batch_refuses_offsets_past_the_arrays():
    boxes, classes, node_offsets, rels, rel_offsets = _ragged(
        5, [4, 4], [3, 3])
    bad = node_offsets.copy()
    bad[-1] += 1
    for fn in (native.pack_graph_batch, native.pack_graph_batch_plain):
        with pytest.raises(ValueError):
            fn(boxes, classes, bad, rels, rel_offsets, 8, 8)
        with pytest.raises(ValueError):
            fn(boxes, classes, node_offsets, rels[:-1], rel_offsets, 8, 8)


def _pairs(seed, n):
    rng = np.random.RandomState(seed)
    b = rng.rand(n, 2, 4).astype(np.float32) * 500
    b[..., 2:] = b[..., :2] + rng.rand(n, 2, 2).astype(np.float32) * 200 + 1
    return b.reshape(n, 8)


@pytest.mark.parametrize("n,P", [(32, 27), (300, 27), (17, 7)])
def test_draw_union_rects_native_equals_jax_and_plain(jax, n, P):
    pairs = _pairs(n, n)
    got = native.draw_union_rects_native(pairs, P)
    assert got.shape == (n, 2, P, P) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax.draw_union_rects_native(pairs, P))
    np.testing.assert_array_equal(got,
                                  native.draw_union_rects_plain(pairs, P))


def test_torch_rasterizer_within_1e4_of_the_oracle():
    pairs = _pairs(0, 256)
    want = native.draw_union_rects_native(pairs, 27)
    got = draw_union_rects(torch.from_numpy(pairs), 27).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_jax_sources_built_here_equal_the_port(tmp_path):
    """The stand-in for a JAX library that failed to build: its sources
    with its Makefile's flags, byte-equal to the port's."""
    lib = jax_library(tmp_path)
    img = _image((600, 800), seed=3)
    for flip in (False, True):
        np.testing.assert_array_equal(_prep(lib.prepare_image_u8, img, flip),
                                      _prep(native.prepare_image_u8, img,
                                            flip))
    pairs = _pairs(1, 64)
    np.testing.assert_array_equal(lib.draw_union_rects(pairs, 27),
                                  native.draw_union_rects_native(pairs, 27))


def test_flags_are_the_jax_makefiles():
    assert native.CXX_FLAGS == makefile_flags()


def test_calls_are_counted():
    lib = native.load()
    lib.reset_counts()
    img = _image((40, 60))
    native.prepare_image_u8(img, 64, 43, 64, False, MEAN_U8)
    native.prepare_image_u8_plain(img, 64, 43, 64, False, MEAN_U8)
    args = (*_ragged(6, [3], [2]), 4, 4)
    native.pack_graph_batch(*args)
    native.pack_graph_batch_plain(*args)
    native.draw_union_rects_native(_pairs(2, 3), 7)
    assert lib.calls == {"prepare_image_u8": 1, "pack_graph_batch": 1,
                         "draw_union_rects": 1}
    lib.reset_counts()
    assert not lib.calls


def test_counts_hold_under_many_threads():
    """Loader threads call the library at once: no count is lost."""
    from concurrent.futures import ThreadPoolExecutor
    lib = native.load()
    lib.reset_counts()
    args = (*_ragged(8, [2], [1]), 2, 2)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=32) as pool:
            futures = [pool.submit(native.pack_graph_batch, *args)
                       for _ in range(4000)]
            want = native.pack_graph_batch_plain(*args)[5]
            for f in futures:
                assert f.result(timeout=60)[5] == want
    finally:
        sys.setswitchinterval(interval)
    assert lib.calls == {"pack_graph_batch": 4000}


@pytest.mark.parametrize("uint8", [True, False], ids=["uint8", "float32"])
def test_prepare_example_takes_the_native_prep_for_uint8_images(uint8):
    """On the uint8 route a uint8 image goes through the native prep and
    nothing else; a float image (a file-less dataset's blank canvas, or
    the float32 route) does not."""
    img = _image((300, 500), seed=4)
    boxes = np.asarray([[10, 10, 200, 150]], np.float32)
    rels = np.zeros((0, 3), np.int32)
    lib = native.load()
    for image in (img, img.astype(np.float32) / 255):
        lib.reset_counts()
        canvas = tpipe.prepare_example(image, boxes, rels, "native", False,
                                       np.random.RandomState(0), im_scale=S,
                                       uint8=uint8)[0]
        want = int(uint8 and image.dtype == np.uint8)
        assert lib.calls["prepare_image_u8"] == want
        if want:
            np.testing.assert_array_equal(
                canvas, _prep(native.prepare_image_u8, img, False))


@pytest.fixture
def broken_compiler(monkeypatch, tmp_path, request):
    """A fresh build directory, no library loaded, and a compiler that is
    missing or that fails with a message."""
    if request.param == "missing":
        cxx = str(tmp_path / "no-such-g++")
    else:
        cxx = tmp_path / "failing-g++"
        cxx.write_text("#!/bin/sh\necho 'fatal: this compiler fails' >&2\n"
                       "exit 3\n")
        cxx.chmod(0o755)
        cxx = str(cxx)
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_library", None)
    return request.param, cxx


@pytest.mark.parametrize("broken_compiler", ["missing", "failing"],
                         indirect=True)
def test_a_failed_build_raises_with_the_log(broken_compiler):
    kind, cxx = broken_compiler
    img = _image((300, 500))
    with pytest.raises(native.NativeBuildError) as e:
        native.prepare_image_u8(img, S, 355, 592, False, MEAN_U8)
    msg = str(e.value)
    assert cxx in msg and "image_prep.cpp" in msg
    assert ("FileNotFoundError" in msg if kind == "missing"
            else "fatal: this compiler fails" in msg and "exit 3" in msg)
    assert not list((native.BUILD_DIR).glob("*.so*"))
    # no caller falls back: the pipeline and the packer raise as well
    with pytest.raises(native.NativeBuildError):
        tpipe.prepare_example(img, np.asarray([[1, 1, 50, 50]], np.float32),
                              np.zeros((0, 3), np.int32), "native", False,
                              np.random.RandomState(0), im_scale=S,
                              uint8=True)
    with pytest.raises(native.NativeBuildError):
        native.pack_graph_batch(*_ragged(7, [3], [2]), 4, 4)


def test_builds_share_one_library_across_processes(tmp_path):
    """Three processes build into one empty directory at once: each gets
    the same library, which loads, and no temporary file is left."""
    code = ("import sys\nfrom sgg_torch import native\n"
            "print(native.build(sys.argv[1]))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    paths = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(paths) == 1
    lib = native.Library(paths.pop())
    assert lib.path.parent == tmp_path
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(
        [lib.path.name, "native.lock"])
    np.testing.assert_array_equal(
        lib.draw_union_rects(_pairs(3, 5), 7),
        native.draw_union_rects_plain(_pairs(3, 5), 7))


def test_library_name_follows_sources_compiler_and_flags(monkeypatch):
    base, cxx = native.library_path(), native.CXX
    assert base.parent == native.BUILD_DIR
    monkeypatch.setattr(native, "CXX", "clang++")
    assert native.library_path() != base
    monkeypatch.setattr(native, "CXX", cxx)
    assert native.library_path() == base
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != base
