"""The port's ``DetectionEvaluator`` (COCO 101-point AP over IoU
0.5:0.95, ``sgg_torch/eval/det_eval.py``) against the JAX package's on the
same detections: every result equal."""

import numpy as np
import pytest

from sgg_tpu.eval.det_eval import DetectionEvaluator as JEval
from sgg_torch.eval.det_eval import COCO_IOUS, DetectionEvaluator


def _images(seed, n_images=6, n_classes=5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_images):
        n_gt = rng.randint(0, 6)
        gt = rng.rand(n_gt, 2) * 80
        gt_boxes = np.concatenate([gt, gt + rng.rand(n_gt, 2) * 40 + 5], 1)
        gt_labels = rng.randint(1, n_classes, n_gt)
        # detections: jittered GT (hits at several IoUs) and strays
        jit = gt_boxes + rng.randn(n_gt, 4) * rng.choice([0.5, 4, 12], n_gt
                                                         )[:, None]
        stray = rng.rand(rng.randint(0, 5), 4) * 60
        stray[:, 2:] += stray[:, :2] + 5
        det_boxes = np.concatenate([jit, stray]).astype(np.float32)
        det_labels = np.concatenate([
            np.where(rng.rand(n_gt) < 0.8, gt_labels,
                     rng.randint(0, n_classes, n_gt)),
            rng.randint(1, n_classes, len(stray))]).astype(np.int64)
        det_scores = rng.rand(len(det_boxes)).astype(np.float32)
        out.append((det_boxes, det_labels, det_scores,
                    gt_boxes.astype(np.float32), gt_labels.astype(np.int64)))
    return out


@pytest.mark.parametrize("seed,max_dets", [(0, 100), (1, 100), (2, 2)])
def test_detection_evaluator_matches_jax(seed, max_dets):
    mine, theirs = DetectionEvaluator(5, max_dets=max_dets), JEval(
        5, max_dets=max_dets)
    for image in _images(seed):
        mine.add_image(*image)
        theirs.add_image(*image)
    got, want = mine.results(), theirs.results()
    assert set(got) == {"mAP", "AP50", "AP75"}
    assert got == want
    assert 0.0 < got["AP50"] <= 1.0


def test_perfect_detections_score_one():
    ev = DetectionEvaluator(3, ious=COCO_IOUS)
    boxes = np.asarray([[0, 0, 10, 10], [20, 20, 40, 50]], np.float32)
    labels = np.asarray([1, 2])
    ev.add_image(boxes, labels, np.asarray([0.9, 0.8], np.float32), boxes,
                 labels)
    assert ev.results() == {"mAP": 1.0, "AP50": 1.0, "AP75": 1.0}
