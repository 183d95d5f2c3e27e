#!/bin/bash
# CLI dress rehearsal of the port: the full command line, through argparse,
# on a schema-exact fixture tree at the real 592 px canvas, on the card
# unless DEVICE is cpu. Counterpart of tools/chip_dress_rehearsal.sh.
# Usage:
#   python -m sgg_torch.tools.make_fixture_dataset DATA all 1.0
#   bash sgg_torch/tools/dress_rehearsal.sh DATA OUT ["stanford gqa vte"] [DEVICE]
# SPLITS picks the chains: stanford (sgcls train, resume with -save_scores,
# -feature_cache, VG detector pretraining -> sgdet), gqa (detector
# fine-tune -> sgcls -> sgdet) and vte (predcls). The stanford and vte
# chains read HDF5 files and the feature cache: they need h5py, which the
# card's machine lacks; there only "gqa" runs. The first failing command
# ends the run with its exit code; the last line says ALL GREEN.
set -euo pipefail
set -x
DATA=${1:?usage: dress_rehearsal.sh DATA OUT [SPLITS] [DEVICE]}
OUT=${2:?usage: dress_rehearsal.sh DATA OUT [SPLITS] [DEVICE]}
SPLITS=${3:-stanford gqa vte}
DEVICE=${4:-cuda}
mkdir -p "$OUT"
export SGG_CHECK_SIZES=0
cd "$(dirname "$0")/../.."

run() { timeout 2300 python -m "$@" -device "$DEVICE"; }

for split in $SPLITS; do
  case "$split" in
  stanford)
    # sgcls: train 1 epoch -> dual eval -> checkpoint
    run sgg_torch.main -m sgcls -split stanford -data "$DATA" -val_size 2 \
        -b 8 -nepoch 1 -p 5 -use_bias -save_dir "$OUT/sgcls"
    # resume (the epoch-0 checkpoint picked up) + -save_scores
    run sgg_torch.main -m sgcls -split stanford -data "$DATA" -val_size 2 \
        -b 8 -nepoch 2 -p 5 -use_bias -save_dir "$OUT/sgcls" -save_scores
    # -feature_cache through the CLI (extraction + cached train/eval)
    run sgg_torch.main -m sgcls -split stanford -data "$DATA" -val_size 2 \
        -b 8 -nepoch 1 -p 5 -save_dir "$OUT/sgcls_fc" \
        -feature_cache "$OUT/fcache"
    # detector pretraining (vg) -> sgdet
    run sgg_torch.pretrain_detector vg "$DATA" "$OUT/det_vg" 1 2 2
    run sgg_torch.main -m sgdet -split stanford -data "$DATA" -val_size 2 \
        -b 4 -nepoch 1 -p 5 -backbone resnet50 -ckpt "$OUT/det_vg" \
        -save_dir "$OUT/sgdet"
    ;;
  gqa)
    # detector fine-tune -> SGCls -> SGGen
    run sgg_torch.pretrain_detector gqa "$DATA" "$OUT/det_gqa" 1 2 2
    run sgg_torch.main -m sgcls -split gqa -data "$DATA" -val_size 2 -b 8 \
        -nepoch 1 -p 5 -backbone resnet50 -exclude_left_right \
        -save_dir "$OUT/gqa"
    run sgg_torch.main -m sgdet -split gqa -data "$DATA" -val_size 2 -b 4 \
        -nepoch 1 -p 5 -backbone resnet50 -ckpt "$OUT/det_gqa" \
        -save_dir "$OUT/gqa"
    ;;
  vte)
    run sgg_torch.main -m predcls -split vte -data "$DATA" -val_size 2 \
        -b 8 -nepoch 1 -p 5 -backbone resnet50 -save_dir "$OUT/vte"
    ;;
  *)
    echo "unknown split $split (stanford, gqa, vte)" >&2
    exit 2
    ;;
  esac
done

set +x
echo "=== artifacts ==="
find "$OUT" -maxdepth 2 \( -name '*.json' -o -name '*.pkl' \) | sort
for f in "$OUT"/*/test_results.json; do echo "--- $f"; cat "$f"; echo; done
echo "DRESS REHEARSAL: ALL GREEN"
