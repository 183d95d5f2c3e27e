"""K1 (csrc/roi_align.cu) in the traced window: the least time its work
could take on the card over its kernel time. Its work, as the
configuration's family counts it (``kernel_work``; the IMP family: two
launches a batch and regime, RoIAlign over the batch's real boxes and
over its valid pairs' unordered unions, each once, from the bf16 map),
the map read once and the pools written once (benchmarks/work.py), the
arithmetic at the f32 CUDA-core peak. Padded slots are not work."""

from benchmarks import work


def read(run):
    tr, ev = run.trace, run.ev
    if tr is None or ev is None:
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
