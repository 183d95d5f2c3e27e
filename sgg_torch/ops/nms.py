"""Fixed-shape NMS and box-delta coding, batched over images.

Counterpart of ``sgg_tpu/ops/nms.py`` (the C++/CUDA detection ops that
torchvision hides inside ``rpn``/``roi_heads``, reference
``sgg_models/rel_model_base.py:210-211``): greedy NMS over score-sorted
boxes with static shapes, and the Faster R-CNN box encode/decode with
torchvision's weights and clamping. NMS is plain tensor code here, as it is
in the JAX package (no Pallas kernel): each of the four methods gives the
same keep set (``rounds`` when its flag says it converged).

Where the JAX package ``vmap``s over images, these functions take a leading
image axis. Sorts are stable (``torch.sort(..., stable=True)``), so equal
scores keep the lower index first, as ``jnp.argsort`` and ``lax.top_k`` do;
``torch.topk``'s tie order on the card is unspecified.
"""

from __future__ import annotations

import math

import torch

from sgg_torch.ops.boxes import box_iou

METHODS = ("sequential", "chunked", "rounds", "fixpoint")


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        iou_thresh: float, max_out: int, method: str = "sequential",
        chunk: int = 64, rounds: int = 16, with_converged: bool = False):
    """Greedy NMS over each image's boxes.

    boxes (B, N, 4); scores (B, N); valid (B, N) bool. Returns (indices
    (B, max_out) int64 into the input, keep mask (B, max_out) bool), the
    kept boxes first in descending-score order, masked slots index 0; with
    ``with_converged`` also (B,) bool, True iff the result is provably the
    greedy solution (always, except ``rounds`` with a suppression chain
    deeper than its budget: callers re-run with ``sequential``).

    ``sequential`` resolves box after box (N steps); ``chunked`` resolves
    ``chunk`` boxes a step after one masked reduction over the finished
    ones; ``rounds`` keeps, each round, every undecided box whose
    higher-scored conflicts are all removed, then removes what the kept
    boxes suppress (two batched matvecs a round, no host sync); ``fixpoint``
    iterates the parallel update to its fixed point, reading a flag from
    the device each iteration. See ``sgg_tpu/ops/nms.py`` for why the four
    agree.
    """
    if method not in METHODS:
        raise ValueError(f"nms method {method!r} not in {METHODS}")
    B, N = scores.shape
    dev = scores.device
    neg = torch.finfo(scores.dtype).min
    s = torch.where(valid, scores, neg)
    order = torch.argsort(-s, dim=1, stable=True)
    sb = torch.gather(boxes, 1, order[..., None].expand(B, N, 4))
    sv = torch.gather(s, 1, order) > neg
    over = box_iou(sb, sb) > iou_thresh  # (B, N, N)
    tri = torch.ones((N, N), dtype=torch.bool, device=dev).triu(1)
    converged = None

    if method == "fixpoint":
        sup_mat = tri & over  # [i, j]: kept i suppresses j
        suppressed = torch.zeros((B, N), dtype=torch.bool, device=dev)
        for _ in range(N):
            kept = sv & ~suppressed
            new = (sup_mat & kept[:, :, None]).any(dim=1)
            if torch.equal(new, suppressed):
                break
            suppressed = new
    elif method == "rounds":
        # supT[j, i]: higher-scored i conflicts j; any_i as matvec > 0 (0/1
        # sums below 2^24 are exact in f32)
        supT = (tri & over).transpose(1, 2).float()
        kept = torch.zeros((B, N), dtype=torch.bool, device=dev)
        removed = torch.zeros_like(kept)
        for _ in range(rounds):
            alive = (sv & ~removed).float()
            blocker = torch.bmm(supT, alive[..., None])[..., 0] > 0.0
            kept = kept | (sv & ~kept & ~removed & ~blocker)
            removed = removed | (
                (torch.bmm(supT, kept.float()[..., None])[..., 0] > 0.0)
                & ~kept)
        converged = (kept | removed | ~sv).all(dim=1)
        suppressed = ~kept
    elif method == "chunked":
        C = min(chunk, N)
        n_chunks = -(-N // C)
        Np = n_chunks * C
        sup_mat = torch.zeros((B, Np, Np), dtype=torch.bool, device=dev)
        sup_mat[:, :N, :N] = over
        sv_p = torch.zeros((B, Np), dtype=torch.bool, device=dev)
        sv_p[:, :N] = sv
        pos = torch.arange(Np, device=dev)
        loc = torch.arange(C, device=dev)
        suppressed = torch.zeros((B, Np), dtype=torch.bool, device=dev)
        for c in range(n_chunks):
            cs = c * C
            # this chunk's suppression by every finished earlier keep
            kept_prefix = sv_p & ~suppressed & (pos < cs)
            sup_local = suppressed[:, cs:cs + C] | (
                kept_prefix[:, :, None] & sup_mat[:, :, cs:cs + C]).any(1)
            sv_local = sv_p[:, cs:cs + C]
            blk = sup_mat[:, cs:cs + C, cs:cs + C]
            for k in range(C):
                keep_k = sv_local[:, k] & ~sup_local[:, k]
                sup_local = sup_local | (keep_k[:, None] & (loc > k)
                                         & blk[:, k])
            suppressed[:, cs:cs + C] = sup_local
        suppressed = suppressed[:, :N]
    else:
        sup_mat = tri & over
        suppressed = torch.zeros((B, N), dtype=torch.bool, device=dev)
        for i in range(N):
            keep_i = sv[:, i] & ~suppressed[:, i]
            suppressed = suppressed | (keep_i[:, None] & sup_mat[:, i])
    if converged is None:
        converged = torch.ones((B,), dtype=torch.bool, device=dev)
    keep = sv & ~suppressed
    # the first max_out kept, in score order, scattered into output slots;
    # every dropped box goes to the spare slot max_out
    kept_rank = torch.cumsum(keep, dim=1) - 1
    out_mask = keep & (kept_rank < max_out)
    slot = torch.where(out_mask, kept_rank, max_out)
    out_idx = torch.zeros((B, max_out + 1), dtype=torch.long,
                          device=dev).scatter_(1, slot, order)[:, :max_out]
    out_valid = torch.zeros((B, max_out + 1), dtype=torch.bool,
                            device=dev).scatter_(1, slot, out_mask)
    out_valid = out_valid[:, :max_out]
    if with_converged:
        return out_idx, out_valid, converged
    return out_idx, out_valid


def encode_boxes(ref: torch.Tensor, gt: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Box -> regression targets (torchvision BoxCoder.encode)."""
    wx, wy, ww, wh = weights
    rw = ref[..., 2] - ref[..., 0]
    rh = ref[..., 3] - ref[..., 1]
    rx = ref[..., 0] + 0.5 * rw
    ry = ref[..., 1] + 0.5 * rh
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = gt[..., 0] + 0.5 * gw
    gy = gt[..., 1] + 0.5 * gh
    rw = rw.clamp(min=1e-6)
    rh = rh.clamp(min=1e-6)
    return torch.stack([
        wx * (gx - rx) / rw, wy * (gy - ry) / rh,
        ww * torch.log(gw.clamp(min=1e-6) / rw),
        wh * torch.log(gh.clamp(min=1e-6) / rh)], dim=-1)


def decode_boxes(ref: torch.Tensor, deltas: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Regression deltas -> boxes (torchvision BoxCoder.decode, with the
    log-space clamp of ``dw``/``dh`` at log(1000/16))."""
    wx, wy, ww, wh = weights
    clamp = math.log(1000.0 / 16)
    rw = ref[..., 2] - ref[..., 0]
    rh = ref[..., 3] - ref[..., 1]
    rx = ref[..., 0] + 0.5 * rw
    ry = ref[..., 1] + 0.5 * rh
    # divided by tensors: by a Python number PyTorch multiplies with the
    # rounded reciprocal on the
    # card, one ulp off the division that the CPU and XLA do
    dx = deltas[..., 0] / torch.full_like(rw, wx)
    dy = deltas[..., 1] / torch.full_like(rw, wy)
    dw = torch.clamp(deltas[..., 2] / torch.full_like(rw, ww), max=clamp)
    dh = torch.clamp(deltas[..., 3] / torch.full_like(rw, wh), max=clamp)
    cx = dx * rw + rx
    cy = dy * rh + ry
    w = torch.exp(dw) * rw
    h = torch.exp(dh) * rh
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], dim=-1)
