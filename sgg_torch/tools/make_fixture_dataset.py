"""Write a miniature, schema-exact dataset tree for CLI dress rehearsals.

    python -m sgg_torch.tools.make_fixture_dataset DATA_DIR [vg|gqa|vte|all]
        [SCALE] [--image-sizes LO:HI]

Counterpart of ``tools/make_fixture_dataset.py`` over the port's
``sgg_torch/data/fixtures.py``: real JPEGs plus the exact file layout of
the real datasets. SCALE multiplies the default image counts (1.0: 120 VG
/ 55 GQA / 42 VTE images, at least 4 a split). The GQA tree is JSON and
needs no ``h5py``; the VG and VTE trees are HDF5 and do.
``--image-sizes LO:HI`` draws the GQA JPEGs' sides from ``[LO, HI)``
pixels instead of the default 240-520 (sizes above the 592 px canvas make
the pipeline's resize shrink, as for real photos). Run the CLI on it
with ``SGG_CHECK_SIZES=0``, which relaxes the full-dataset size checks:

    SGG_CHECK_SIZES=0 python -m sgg_torch.main -m sgcls -split stanford \\
        -data DATA_DIR -val_size 2 -nepoch 2 -save_dir <run dir>
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from sgg_torch.data import fixtures


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    image_sizes = None
    if "--image-sizes" in argv:
        i = argv.index("--image-sizes")
        try:
            lo, hi = (int(v) for v in argv[i + 1].split(":"))
        except (IndexError, ValueError):
            raise SystemExit(f"--image-sizes wants LO:HI\n{__doc__}")
        if not 0 < lo < hi:
            raise SystemExit(f"--image-sizes {lo}:{hi}: want 0 < LO < HI")
        image_sizes = (lo, hi)
        del argv[i:i + 2]
    if not argv:
        raise SystemExit(__doc__)
    data_dir = argv[0]
    which = argv[1] if len(argv) > 1 else "all"
    scale = float(argv[2]) if len(argv) > 2 else 1.0

    def s(n):
        return max(int(n * scale), 4)

    if which in ("vg", "all"):
        fixtures.write_vg_fixture(data_dir, n_train=s(90), n_test=s(30))
        print(f"VG fixture -> {data_dir}/VG")
    if which in ("gqa", "all"):
        fixtures.write_gqa_fixture(data_dir, n_train=s(40), n_val=s(15),
                                   image_sizes=image_sizes)
        print(f"GQA fixture -> {data_dir}/GQA")
    if which in ("vte", "all"):
        fixtures.write_vte_fixture(data_dir, n_train=s(30), n_test=s(12))
        print(f"VTE fixture -> {data_dir}/VG/vtranse")


if __name__ == "__main__":
    main()
