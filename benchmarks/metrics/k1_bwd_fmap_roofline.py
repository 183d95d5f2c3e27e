"""K1-bwd-fmap (csrc/roi_align_bwd.cu, the map's gradient: its tile masks,
tile lists and gathers, every route): the least time its work could take
over its kernel time in the traced steps. Its work, as the configuration's
family counts it (``kernel_work``; the IMP family, in the GAN's G phase:
the gradient of the fake map, float32, from the pools of the real boxes
and of the sampled edges' union boxes, one launch each); the pools'
gradient read once, the map's written once (benchmarks/work.py)."""

import re

from benchmarks import work

K = re.compile(r"tile_masks_lines_kernel|tile_lists_kernel|"
               r"fmap_gather_(mma_heavy_|mma_)?kernel")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    launches = run.cell.family.kernel_work(run, "k1_bwd_fmap")
    if launches is None:
        return None
    ns = sum(e - s for name, s, e in tr.kernels if K.search(name))
    if ns == 0:
        return None
    pk = run.peaks
    bound = 0.0
    for w, n in launches:
        bound += work.bound_s(w, pk["f32"], pk["hbm_bytes_per_s"]) * n
    return 100.0 * bound / (ns / 1e9)
