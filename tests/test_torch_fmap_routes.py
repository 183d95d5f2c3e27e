"""K1-bwd-fmap's routes on the CPU: the names of its gather kernels against
the benchmark's reader of its device time, the route predicate that
mirrors its launcher, and the count of launches by route.

The card tests (``test_torch_cuda.py``) hold the launcher's own choice
(``sgg_roi_align_bwd_fmap_route``) equal to ``fmap_route``."""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from sgg_torch.ops import roi_align as troi
from sgg_torch.utils import counters

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "sgg_torch" / "csrc" / "roi_align_bwd.cu"
READER = ROOT / "benchmarks" / "metrics" / "k1_bwd_fmap_roofline.py"


def _reader_pattern():
    spec = importlib.util.spec_from_file_location(
        "benchmarks.metrics.k1_bwd_fmap_roofline", READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.K


def _kernel_names(text):
    """The names of the ``__global__`` functions of a CUDA source, past
    their ``__cluster_dims__`` and ``__launch_bounds__``."""
    return re.findall(
        r"__global__\s+void\s+(?:__cluster_dims__\([^)]*\)\s*)?"
        r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", text)


def test_every_map_gradient_kernel_is_named_for_its_reader():
    """Each of K1-bwd-fmap's kernels (every ``__global__`` of its source
    but K1-bwd-boxes') matches the pattern by which
    ``k1_bwd_fmap_roofline`` finds its device time, so that a rename
    cannot leave a gather's time out of the metric."""
    names = _kernel_names(SOURCE.read_text())
    fmap = [n for n in names if "boxes" not in n]
    assert len(names) == len(fmap) + 1, names
    gathers = [n for n in fmap if "gather" in n]
    assert {"staged_fmap_gather_kernel",
            "staged_heavy_fmap_gather_kernel"} <= set(gathers), gathers
    K = _reader_pattern()
    assert [n for n in fmap if not K.search(n)] == []


@pytest.mark.parametrize("dtype, C, ptr, R, route", [
    (torch.float32, 512, 0x7f0000000000, 576, "f32-staged"),
    (torch.float32, 200, 0x7f0000000010, 4096, "f32-staged"),
    (torch.float32, 203, 0x7f0000000000, 64, "f32-gather"),
    (torch.float32, 512, 0x7f0000000004, 64, "f32-gather"),
    (torch.float32, 512, 0x7f0000000008, 64, "f32-gather"),
    (torch.float32, 512, 0x7f0000000000, 4097, "f32-gather"),
    (torch.bfloat16, 512, 0x7f0000000000, 576, "bf16-mma"),
    (torch.bfloat16, 200, 0x7f0000000000, 64, "bf16-mma"),
    (torch.bfloat16, 204, 0x7f0000000000, 64, "bf16-gather"),
    (torch.bfloat16, 512, 0x7f0000000008, 64, "bf16-gather"),
    (torch.bfloat16, 256, 0x7f0000000000, 4097, "bf16-gather"),
])
def test_route_follows_type_channels_alignment_and_rois(dtype, C, ptr, R,
                                                         route):
    """The map's type, C, g's alignment and the ROIs an image choose the
    route: staged where g is 16-byte aligned and a tile's list fits shared
    memory (C % 4 for f32, C % 8 for bf16), else the unstaged gather."""
    assert troi.fmap_route(dtype, C, ptr, R) == route
    assert route in troi.FMAP_ROUTES


class _Launches:
    """Stands in for K1-bwd-fmap's library: records each launch's route."""

    def __init__(self):
        self.routes = []

    def launch(self, *args, route):
        self.routes.append(route)


@pytest.mark.parametrize("dtype, C, offset, route", [
    (torch.float32, 512, 0, "f32-staged"),
    (torch.float32, 203, 0, "f32-gather"),
    (torch.float32, 512, 1, "f32-gather"),
    (torch.bfloat16, 256, 0, "bf16-mma"),
    (torch.bfloat16, 256, 4, "bf16-gather"),
])
def test_each_launch_counts_once_under_its_route(dtype, C, offset, route,
                                                 monkeypatch):
    """``_grad_fmap_kernel`` launches on the route that ``fmap_route``
    gives for its ``g`` (misaligned by a view ``offset`` elements into its
    storage) and bumps ``k1_bwd_fmap.<route>`` once a call."""
    fake = _Launches()
    monkeypatch.setattr(troi, "KERNEL_BWD_FMAP", fake)
    monkeypatch.setattr(troi, "fmap_workspace_layout",
                        lambda *a, **k: {"bytes": 64})
    monkeypatch.setattr(troi, "_stream", lambda t: 0)
    B, R = 2, 5
    flat = torch.zeros(B * R * 49 * C + offset, dtype=dtype)
    g = flat[offset:].view(B, R, 7, 7, C)
    assert g.data_ptr() % 16 == (0 if offset == 0 else
                                 offset * g.element_size() % 16)
    boxes = torch.zeros(B, R, 4)
    before = counters.snapshot()
    for _ in range(3):
        grad = troi._grad_fmap_kernel(g, boxes, (B, 9, 11, C), dtype,
                                      1 / 16, 7, 2)
        assert grad.shape == (B, 9, 11, C) and grad.dtype == dtype
    assert fake.routes == [route] * 3
    assert counters.delta(before) == {f"k1_bwd_fmap.{route}": 3}
