"""Dataset acquisition: Yandex-disk public links → tar extraction.

The port's copy of ``sgg_tpu/data/download.py``, a rebuild of the
reference's ``lib/download.py``: resolves the public VG/GQA
archive links through the Yandex cloud REST API, downloads with resumable
``urllib`` streaming (the reference shells out to wget), and extracts the
tars into ``{root}/VG`` and ``{root}/GQA``. Network failures raise with the
same manual-download guidance. In zero-egress environments this module is
inert — callers gate on ``data_exists``.
"""

from __future__ import annotations

import json
import os
import tarfile
import urllib.parse
import urllib.request

VG_LINK = ("https://yadi.sk/d/unHhlZ0YOjCMQQ", "VG.tar")
GQA_LINK = ("https://yadi.sk/d/FGOzRP649rZ2kQ", "GQA_scenegraphs.tar")
_API = ("https://cloud-api.yandex.net/v1/disk/public/resources/download"
        "?public_key={}")


def data_exists(root: str, split: str = "stanford") -> bool:
    """Reference ModelConfig.data_exists (config.py:137-142)."""
    if split == "gqa":
        return os.path.exists(
            os.path.join(root, "GQA", "train_balanced_questions.json"))
    return (os.path.exists(os.path.join(root, "VG", "VG_100K"))
            and os.path.exists(os.path.join(root, "VG", "stanford_filtered")))


def download(url_name_pair, data_dir: str, chunk: int = 1 << 20) -> str:
    url, name = url_name_pair
    filename = os.path.join(data_dir, name)
    if not os.path.isfile(filename):
        api_url = _API.format(urllib.parse.quote(url))
        with urllib.request.urlopen(api_url, timeout=60) as resp:
            info = json.loads(resp.read())
        if "href" not in info:
            raise ValueError(
                info.get("error"),
                "Try running the script later or download the archive "
                f"manually from {url} into {data_dir} (see README).")
        print(f"Downloading {filename} (can take a few hours)...")
        tmp = filename + ".part"
        with urllib.request.urlopen(info["href"]) as resp, \
                open(tmp, "wb") as out:
            while True:
                buf = resp.read(chunk)
                if not buf:
                    break
                out.write(buf)
        os.replace(tmp, filename)
    print(f"extracting {filename} to {data_dir}")
    try:
        with tarfile.open(filename) as tar:
            tar.extractall(path=data_dir)
    except Exception:
        print(f"Error extracting {filename}; if the download was "
              "interrupted, remove the file and retry.")
        raise
    return filename


def download_all_data(root_dir: str, gqa: bool = True, vg: bool = True):
    os.makedirs(root_dir, exist_ok=True)
    for name, link, enabled in (("GQA", GQA_LINK, gqa), ("VG", VG_LINK, vg)):
        if not enabled:
            continue
        data_dir = os.path.join(root_dir, name)
        os.makedirs(data_dir, exist_ok=True)
        download(link, data_dir)


if __name__ == "__main__":
    import sys
    download_all_data(sys.argv[1])
