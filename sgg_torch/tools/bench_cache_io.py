"""Feature-cache IO economics at real-data scale.

    python -m sgg_torch.tools.bench_cache_io [--entries 8000] [--gb-cap 30]
        [--reads 3000] [--trunk-img-s 400] [--path FILE] [--keep]

Counterpart of ``tools/bench_cache_io.py`` over the port's
``FeatureCache`` (``data/feature_cache.py``). The frozen-trunk cache
trades disk reads for trunk recompute: it pays only when random reads
out of a VG-scale HDF5 file (57,723 entries, ~160 GB at 2 orientations)
beat the trunk's images/s. The tool creates a file with that index space
and the real chunk shape ((1, 1, 37, 37, 512) bf16, 1.4 MB), writes a
scattered subset of entries (chunked storage allocates per chunk, so the
layout matches the full file's), then times random reads in shuffled
order, warm (page cache) and cold (``drop_caches``, root only; else a
second warm pass). It touches no card: ``--trunk-img-s`` is the trunk
rate to compare with (measure it with ``profile_trunk``). HDF5 needs
``h5py``, which the card's machine lacks: a host tool. The last line is
one JSON object: write and read rates and the break-even verdict.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def drop_page_cache() -> bool:
    """Best-effort page-cache drop (root). Returns True on success."""
    try:
        os.sync()
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3\n")
        return True
    except OSError:
        return False


def verdict(res: Dict, trunk_img_s: float) -> Dict:
    """The break-even fields for measured ``res``: the cold read rate
    (the first warm one when no cache could be dropped) against the trunk.
    The cache reads one orientation an image an epoch and the trunk runs
    once an image an epoch: the same unit."""
    read_rate = res.get("read_cold_img_s", res["read_warm_img_s"])
    return {"trunk_img_s": trunk_img_s,
            "cache_speedup_vs_recompute": read_rate / trunk_img_s,
            "verdict": ("cache wins" if read_rate > trunk_img_s
                        else "recompute wins on this disk")}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", default=None,
                    help="the cache file (default: a temporary file)")
    ap.add_argument("--total", type=int, default=57723,
                    help="index space of the file (VG train size)")
    ap.add_argument("--entries", type=int, default=8000,
                    help="entries actually written (scattered)")
    ap.add_argument("--gb-cap", type=float, default=30.0,
                    help="hard cap on bytes written")
    ap.add_argument("--shape", type=int, nargs=3, default=[37, 37, 512],
                    help="fmap (h, w, C) — 592 px VGG16 default")
    ap.add_argument("--n-orient", type=int, default=2)
    ap.add_argument("--reads", type=int, default=3000)
    ap.add_argument("--trunk-img-s", type=float, default=400.0,
                    help="trunk recompute rate to compare against")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args(argv)

    from sgg_torch.data.feature_cache import FeatureCache

    path = args.path or os.path.join(tempfile.gettempdir(),
                                     f"cache_io_bench.{os.getpid()}.h5")
    h, w, c = args.shape
    entry_bytes = args.n_orient * h * w * c * 2
    n_entries = min(args.entries,
                    int(args.gb_cap * 2**30 / max(entry_bytes, 1)))
    rng = np.random.RandomState(0)
    written = np.sort(rng.choice(args.total, size=n_entries, replace=False))

    cache = FeatureCache.create(path, args.total, (h, w), c,
                                n_orient=args.n_orient, fingerprint="iobench")
    # one random payload reused (dirty pages dominate write cost, not RNG)
    payload = torch.from_numpy(
        rng.randn(args.n_orient, h, w, c).astype(np.float32))
    t0 = time.time()
    for i in written:
        cache.write(int(i), payload, (600, 800))
    cache.flush()
    os.sync()
    write_s = time.time() - t0
    file_gb = os.path.getsize(path) / 2**30
    cache.close()

    def read_pass(label):
        cache = FeatureCache(path)
        order = written[rng.permutation(n_entries)][:args.reads]
        flips = rng.randint(0, args.n_orient, size=len(order))
        t0 = time.time()
        nbytes = 0
        for idx, fl in zip(order, flips):
            fm = cache.read(int(idx), bool(fl))
            nbytes += fm.numel() * fm.element_size()
        dt = time.time() - t0
        cache.close()
        return {f"read_{label}_img_s": len(order) / dt,
                f"read_{label}_mb_s": nbytes / dt / 2**20}

    try:
        res = {
            "entry_mb": entry_bytes / 2**20,
            "entries_written": int(n_entries),
            "file_gb": round(file_gb, 2),
            "full_vg_gb": round(args.total * entry_bytes / 2**30, 1),
            "write_img_s": n_entries / write_s,
            "write_mb_s": n_entries * entry_bytes / write_s / 2**20,
        }
        res.update(read_pass("warm"))
        cold_ok = drop_page_cache()
        res["cold_cache_dropped"] = cold_ok
        res.update(read_pass("cold" if cold_ok else "warm2"))
        res.update(verdict(res, args.trunk_img_s))
    finally:
        if not args.keep:
            os.remove(path)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
