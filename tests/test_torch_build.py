"""The cache key of ``repro_torch.kernels.build``: a
library is named by the hash of its source, of every local header the
source includes (beside it or in the common header directory) and of
the flags, so editing ``hopper.cuh`` rebuilds both tensor-core
kernels, and editing ``sorted_search.cuh`` membership and intersect.
Works on copies under ``tmp_path`` and never runs ``nvcc``."""
import shutil

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.kernels.intersect import kernel as inter_kernel
from repro_torch.kernels.membership import kernel as memb_kernel
from repro_torch.kernels.moe_gemm import kernel as moe_kernel
from repro_torch.kernels.segment_spmm import kernel as spmm_kernel
from repro_torch.kernels.varint import kernel as varint_kernel

HOPPER = build.COMMON_DIR / "hopper.cuh"
SORTED_SEARCH = build.COMMON_DIR / "sorted_search.cuh"


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of both tensor-core sources and of the shared header, the
    header in its own include directory as in the package."""
    (tmp_path / "inc").mkdir()
    (tmp_path / "src").mkdir()
    header = tmp_path / "inc" / "hopper.cuh"
    shutil.copy(HOPPER, header)
    sources = []
    for kern in (flash_kernel, moe_kernel):
        dst = tmp_path / "src" / kern.SOURCE.name
        shutil.copy(kern.SOURCE, dst)
        sources.append(dst)
    monkeypatch.setattr(build, "COMMON_DIR", tmp_path / "inc")
    return sources, header


@pytest.mark.parametrize("which", [0, 1], ids=["flash_attn", "moe_gemm"])
def test_header_edit_changes_library_path(tree, which):
    sources, header = tree
    src = sources[which]
    before = build.library_path(src)
    assert build.library_path(src) == before          # stable
    header.write_text(header.read_text() + "\n// an edit\n")
    after = build.library_path(src)
    assert after != before
    assert after.name.startswith(f"lib{src.stem}-")


def test_source_edit_changes_only_its_own_library(tree):
    (flash, moe), _ = tree
    paths = build.library_path(flash), build.library_path(moe)
    flash.write_text(flash.read_text() + "\n// an edit\n")
    assert build.library_path(flash) != paths[0]
    assert build.library_path(moe) == paths[1]


def test_package_sources_find_the_shared_header():
    for kern in (flash_kernel, moe_kernel):
        assert build.local_headers(kern.SOURCE) == [HOPPER.resolve()]
    # toolkit headers (<cuda.h>, ...) are not local; a header beside the
    # source is found there: segment_spmm's forward and backward share
    # segment_spmm.cuh; a source without local includes hashes alone
    shared = spmm_kernel.SOURCE.with_name("segment_spmm.cuh").resolve()
    for src in (spmm_kernel.SOURCE, spmm_kernel.BWD_SOURCE):
        assert build.local_headers(src) == [shared]
    assert build.local_headers(varint_kernel.SOURCES[0]) == []
    assert "-I" in build.NVCC_FLAGS
    assert build.NVCC_FLAGS[build.NVCC_FLAGS.index("-I") + 1] == str(
        build.COMMON_DIR)


def test_sorted_search_edit_changes_both_libraries(tmp_path, monkeypatch):
    """membership and intersect share ``sorted_search.cuh``: an edit to it
    renames both libraries and no other."""
    (tmp_path / "inc").mkdir()
    (tmp_path / "src").mkdir()
    header = tmp_path / "inc" / SORTED_SEARCH.name
    shutil.copy(SORTED_SEARCH, header)
    shutil.copy(HOPPER, tmp_path / "inc" / HOPPER.name)
    sources = []
    for kern in (memb_kernel, inter_kernel, flash_kernel):
        dst = tmp_path / "src" / kern.SOURCE.name
        shutil.copy(kern.SOURCE, dst)
        sources.append(dst)
    monkeypatch.setattr(build, "COMMON_DIR", tmp_path / "inc")
    for src in sources[:2]:
        assert build.local_headers(src) == [header.resolve()]
    before = [build.library_path(src) for src in sources]
    header.write_text(header.read_text() + "\n// an edit\n")
    after = [build.library_path(src) for src in sources]
    assert after[0] != before[0] and after[1] != before[1]
    assert after[2] == before[2]
