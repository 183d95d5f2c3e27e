"""K1 (csrc/roi_align.cu, every route): the least time its work could take
on the card over its kernel time in the traced steps. Its work: RoIAlign
over the real boxes (nodes) and the sampled edges' union boxes, one
launch each a forward (the real map's in the compute type; with a GAN
also the fake map's, float32, in the G phase and in the reconstruction),
the map read once, the pools written once (benchmarks/work.py), the
arithmetic at the f32 CUDA-core peak."""

from benchmarks import work

ELEM = {"bfloat16": 2, "float32": 4}


def read(run):
    tr = run.trace
    if tr is None or run.rec.trace_steps == 0:
        return None
    ns = sum(e - s for name, s, e in tr.kernels if "roi_align_kernel" in name)
    if ns == 0:
        return None
    cfg, pk = run.cfg, run.peaks
    maps = [ELEM[cfg["compute_dtype"]]] + ([4, 4] if cfg.get("gan") else [])
    bound = 0.0
    for ns_img, ms_img in run.step_sizes(run.rec.trace_first_step,
                                         run.rec.trace_steps):
        for elem in maps:
            for rois in (sum(ns_img), sum(ms_img)):
                bound += work.bound_s(
                    work.roi_align_work(rois, cfg["batch_size"],
                                        cfg["im_scale"], cfg["fmap_channels"],
                                        elem),
                    pk["f32"], pk["hbm_bytes_per_s"])
    return 100.0 * bound / (ns / 1e9)
