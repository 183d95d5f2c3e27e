"""K1 (csrc/roi_align.cu, every route): the least time its work could take
on the card over its kernel time in the traced steps. Its work: RoIAlign
over the boxes of each of its launches, as the configuration's family
counts them (``kernel_work``; the IMP family: the real boxes and the
sampled edges' union boxes, one launch each a forward, on the real map
in the compute type and, with a GAN, on the fake map, float32, in the G
phase and in the reconstruction), the map read once, the pools written
once (benchmarks/work.py), the arithmetic at the f32 CUDA-core peak."""

from benchmarks import work


def read(run):
    tr = run.trace
    if tr is None or run.rec.trace_steps == 0:
        return None
    ns = sum(e - s for name, s, e in tr.kernels if "roi_align_kernel" in name)
    if ns == 0:
        return None
    launches = run.cell.family.kernel_work(run, "k1")
    if launches is None:
        return None
    pk = run.peaks
    bound = 0.0
    for w, n in launches:
        bound += work.bound_s(w, pk["f32"], pk["hbm_bytes_per_s"]) * n
    return 100.0 * bound / (ns / 1e9)
