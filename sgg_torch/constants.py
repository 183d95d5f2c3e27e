"""Global constants of the SGG pipeline.

The port's own copy of ``sgg_tpu/constants.py`` (reference ``config.py:28-41``).
Values are kept identical where they define *semantics* (annotation
coordinate scale, input resolution, sampling fractions); the padded
node/edge shape buckets are new — the reference uses ragged batches, the
port keeps the fixed padded shapes of the JAX package.
"""

# Evaluation regimes (reference config.py:28).
MODES = ("sgdet", "sgcls", "predcls")

# Scale of the bounding boxes stored in VG-SGG.h5 annotations
# (reference config.py:30).
BOX_SCALE = 1024

# Input image resolution fed to the VGG16 backbone (reference config.py:31).
# SGG_IM_SCALE overrides it process-wide (must be a multiple of STRIDE=16):
# CPU-tier end-to-end CLI tests run the identical program at a smaller
# canvas so the VGG trunk doesn't dominate the suite; real runs keep 592.
import os as _os

IM_SCALE = int(_os.environ.get("SGG_IM_SCALE", "592"))
assert IM_SCALE % 16 == 0, f"SGG_IM_SCALE must be a multiple of 16: {IM_SCALE}"

# Fraction of sampled relation edges that are foreground
# (reference config.py:33).
REL_FG_FRACTION = 0.25

# Detector box-sampling constants (reference config.py:35-41).
FG_FRACTION = 0.25
FG_THRESH = 0.5
BG_THRESH_HI = 0.5
BG_THRESH_LO = 0.0
ROIS_PER_IMG = 256

BATCHNORM_MOMENTUM = 0.01

# Feature-map geometry of the VGG16 backbone: stride-16 features, RoIAlign to
# 7x7 (reference sgg_models/rel_model_base.py:50-52,84-85).
POOL_SIZE = 7
STRIDE = 16
FMAP_SIZE = IM_SCALE // STRIDE  # 37 (the reference reports 38 due to padding)
VGG_OBJ_DIM = 4096
RESNET_OBJ_DIM = 1024

# Side of the rasterized subject/object mask pair fed to the edge conv
# (reference lib/get_union_boxes.py:67: pooling_size * 4 - 1).
RECT_SIZE = POOL_SIZE * 4 - 1  # 27

# Recall@K cutoffs of the evaluation protocol (reference lib/sgg_eval.py:19).
RECALL_KS = (20, 50, 100, 200, 300)
MAX_RECALL_K = 300

# Default padded-shape buckets (no reference analogue — the
# reference concatenates ragged per-image graphs, dataloaders/blob.py).
MAX_NODES = 64
MAX_EDGES = 576
