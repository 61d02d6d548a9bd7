"""The kernel build's library name, on the CPU (no nvcc needed): it
follows the source, every header beside it and the flags, so an edited
header rebuilds the kernels that include it."""

import os

import pytest

from monopsr_torch.ops import cuda_build


@pytest.fixture
def kernel(tmp_path, monkeypatch):
    """A kernel 'k' whose source and header lie in a temporary directory."""
    source = tmp_path / 'k.cu'
    header = tmp_path / 'shared.cuh'
    source.write_text('#include "shared.cuh"\nextern "C" int k() { return 1; }\n')
    header.write_text('constexpr int kTile = 4;\n')
    monkeypatch.setattr(cuda_build, 'SOURCES', {'k': str(source)})
    return source, header


def test_library_path_changes_with_header_only(kernel):
    source, header = kernel
    before = cuda_build.library_path('k')
    assert cuda_build.library_path('k') == before
    assert os.path.dirname(before) == cuda_build.BUILD_DIR
    header.write_text('constexpr int kTile = 2;\n')
    after = cuda_build.library_path('k')
    assert after != before
    header.write_text('constexpr int kTile = 4;\n')
    assert cuda_build.library_path('k') == before


def test_library_path_changes_with_source_new_header_and_flags(
        kernel, monkeypatch):
    source, header = kernel
    before = cuda_build.library_path('k')
    source.write_text(source.read_text() + '// edited\n')
    edited = cuda_build.library_path('k')
    assert edited != before
    (header.parent / 'other.cuh').write_text('// another header\n')
    with_header = cuda_build.library_path('k')
    assert with_header != edited
    monkeypatch.setattr(cuda_build, 'NVCC_FLAGS',
                        cuda_build.NVCC_FLAGS + ('-lineinfo',))
    assert cuda_build.library_path('k') != with_header


def test_flags_keep_denormals():
    """No fast math: the 1e-20 distance floor and the first rounds'
    subnormal tails need denormals kept."""
    assert '--use_fast_math' not in cuda_build.NVCC_FLAGS
    assert not any('ftz=true' in flag for flag in cuda_build.NVCC_FLAGS)
