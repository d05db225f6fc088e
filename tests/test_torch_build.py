"""The build key of the port's CUDA kernels (``repro_torch.kernels.build``).

A kernel's library is named by a hash of its source, of every port header
the source includes and of the nvcc flags, so a header edit rebuilds the
kernels that include it instead of reusing a stale library.  No ``nvcc``
is needed: these tests only compute keys.
"""
from pathlib import Path

import pytest

from repro_torch.kernels import build

KERNELS = Path(build.__file__).resolve().parent


def write(path: Path, text: str) -> Path:
    path.write_text(text)
    return path


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A source including a header beside it, which includes a second one
    from the shared include directory (a temporary one here)."""
    shared = tmp_path / "shared"
    shared.mkdir()
    monkeypatch.setattr(build, "INCLUDE_DIR", shared)
    src = tmp_path / "k" / "kern.cu"
    src.parent.mkdir()
    write(src, '#include <cuda_runtime.h>\n#include "local.cuh"\n'
               'extern "C" int f() { return 0; }\n')
    write(src.parent / "local.cuh", '#pragma once\n#include "common.cuh"\n')
    write(shared / "common.cuh", "#pragma once\nconstexpr int A = 1;\n")
    return src, src.parent / "local.cuh", shared / "common.cuh"


def test_headers_found_directly_and_through_headers(tree):
    src, local, common = tree
    assert build.included_headers(src) == [local.resolve(),
                                           common.resolve()]


@pytest.mark.parametrize("which", ["source", "local", "common"])
def test_library_path_changes_with_each_input(tree, which):
    """Editing the source, the header beside it or the shared header it
    reaches through that one gives a new library name; an edit undone
    gives the old one back."""
    files = dict(zip(("source", "local", "common"), tree))
    before = build.library_path(files["source"])
    text = files[which].read_text()
    write(files[which], text + "// edited\n")
    after = build.library_path(files["source"])
    assert after != before
    assert after.parent == build.BUILD_DIR and after.suffix == ".so"
    write(files[which], text)
    assert build.library_path(files["source"]) == before


def test_system_headers_do_not_count(tree):
    """``<...>`` includes and names found in no port directory are not
    the port's: they leave the key alone."""
    src, _, _ = tree
    before = build.library_path(src)
    write(src, src.read_text().replace(
        "#include <cuda_runtime.h>", '#include <cuda_bf16.h>\n'
        '#include "not_in_the_port.h"'))
    assert build.included_headers(src)[-1].name == "common.cuh"
    assert build.library_path(src) != before      # the source changed


def test_port_kernels_key_on_the_shared_header():
    """The two tensor-core sources that include ``hopper.cuh`` list it;
    their keys hash it."""
    hopper = (KERNELS / "csrc" / "hopper.cuh").resolve()
    for src in (KERNELS / "dropout_matmul" / "csrc" / "dropout_matmul.cu",
                KERNELS / "paged_attention" / "csrc" /
                "paged_chunk_attention.cu"):
        assert hopper in build.included_headers(src)
