"""How the port's CUDA sources are built: per-source flags and a hash that
covers every header a source includes.

Nothing here runs ``nvcc`` (the card's machine builds); these tests check the
build's bookkeeping, which decides whether a stale library could be served.
"""
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


def test_each_source_has_its_own_flags():
    for name in _build.SOURCES:
        flags = _build.nvcc_flags(name)
        assert "arch=compute_90a,code=sm_90a" in flags
        assert flags[: len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    # the cover kernel is held bitwise to its plain version: no contraction
    assert "--fmad=false" in _build.nvcc_flags("cover")
    assert "--fmad=false" in _build.nvcc_flags("rmsnorm")
    assert "--fmad=false" not in _build.nvcc_flags("flash_attention")


def test_includes_finds_the_attention_headers():
    found = {p.name for p in _build.includes(_build.CSRC / "flash_attention.cu")}
    assert found == {"attention_common.cuh", "flash_bwd.cuh", "flash_splitkv.cuh",
                     "flash_wgmma.cuh"}
    assert [p.name for p in _build.includes(_build.CSRC / "cover.cu")] == ["philox.cuh"]
    assert _build.includes(_build.CSRC / "rmsnorm.cu") == []


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", dst)
    return dst


def test_library_hash_follows_the_source_its_headers_and_its_flags(csrc_copy, monkeypatch):
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    assert len(set(before.values())) == len(before)
    assert all(p.parent == _build.BUILD_DIR for p in before.values())
    # an edited header changes the attention library's name, and no other
    header = csrc_copy / "flash_splitkv.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["cover"] == before["cover"] and after["rmsnorm"] == before["rmsnorm"]
    # so does a change of that source's own flags
    monkeypatch.setitem(_build.SOURCE_FLAGS, "cover", ())
    assert _build.library_path("cover") != before["cover"]


def test_a_header_included_through_another_is_hashed(csrc_copy):
    before = _build.library_path("flash_attention")
    common = csrc_copy / "attention_common.cuh"
    common.write_text(common.read_text() + "\n// edited\n")
    assert _build.library_path("flash_attention") != before
