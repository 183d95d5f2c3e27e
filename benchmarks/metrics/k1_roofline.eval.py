"""K1 (csrc/roi_align.cu) in the traced window: the least time its work
could take on the card over its kernel time. Its work, two launches a
batch and regime: RoIAlign over the batch's real boxes and over its
valid pairs' unordered unions, each once, from the bf16 map, the map
read once and the pools written once (benchmarks/work.py), the
arithmetic at the f32 CUDA-core peak. Padded slots are not work."""

from benchmarks import evaluation, work

ELEM = {"bfloat16": 2, "float32": 4}


def read(run):
    tr, ev = run.trace, run.ev
    if tr is None or ev is None:
        return None
    ns = sum(e - s for name, s, e in tr.kernels if "roi_align_kernel" in name)
    if ns == 0:
        return None
    cfg, pk = run.cfg, run.peaks
    bound = 0.0
    for counts in evaluation.batch_counts(run.split, cfg):
        for rois in (sum(counts), sum(n * (n - 1) // 2 for n in counts)):
            bound += work.bound_s(
                work.roi_align_work(rois, len(counts), cfg["im_scale"],
                                    cfg["fmap_channels"],
                                    ELEM[cfg["compute_dtype"]]),
                pk["f32"], pk["hbm_bytes_per_s"])
    return 100.0 * 2 * bound / (ns / 1e9)
