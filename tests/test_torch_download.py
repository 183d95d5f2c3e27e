"""The port's downloader (``sgg_torch/data/download.py``) under the mocked
cases of ``tests/test_download.py``: the same tests, run on the port's
module (mocked Yandex REST resolution, streamed ``.part`` download and
rename, extraction, the skip of an archive already there, the manual
download guidance, a corrupt archive's hint, the data layout). No test
reaches the network: the module's ``urlopen`` raises unless a test mocks
it."""

import inspect

import pytest

import test_download as jtests
from sgg_tpu.data import download as jdl
from sgg_torch.data import download as tdl

CASES = sorted(n for n, f in vars(jtests).items()
               if n.startswith("test_") and callable(f))


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the network was reached")

    monkeypatch.setattr(tdl.urllib.request, "urlopen", refuse)


def test_links_and_resolver_are_sgg_tpus():
    assert (tdl.VG_LINK, tdl.GQA_LINK, tdl._API) \
        == (jdl.VG_LINK, jdl.GQA_LINK, jdl._API)
    assert len(CASES) == 6


@pytest.mark.parametrize("case", CASES)
def test_mocked_case_on_the_port(case, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jtests, "dl", tdl)
    fn = getattr(jtests, case)
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch,
                "capsys": capsys}
    fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})
