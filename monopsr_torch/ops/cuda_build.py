"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface, compiled
for Hopper (``sm_90a``) into a shared library under
``build/monopsr_torch_kernels/`` at the repository root (listed in
.gitignore). The library name carries a hash of the source, of every
header (``*.cuh``) beside it and of the flags, so an edited source or
header is rebuilt and an unchanged one is reused. Nothing
is built or loaded at import time: the first call to ``load`` builds.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Kernel name -> source under the package
SOURCES = {
    'emd_cost_fused': os.path.join('csrc', 'emd_cost_fused.cu'),
    'emd_loss': os.path.join('csrc', 'emd_loss.cu'),
}

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), 'build',
                         'monopsr_torch_kernels')

_LOADED = {}


def source_path(name):
    return os.path.join(_PACKAGE_DIR, SOURCES[name])


def library_path(name):
    """The library of kernel ``name``, named by a hash of its source, the
    headers in the source's directory (any of them may be included) and
    the flags."""
    source = source_path(name)
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(os.path.dirname(source),
                                            '*.cuh')))
    for path in [source] + headers:
        with open(path, 'rb') as f:
            digest.update(os.path.basename(path).encode() + b'\0' +
                          f.read())
    return os.path.join(BUILD_DIR, '{}-{}.so'.format(
        name, digest.hexdigest()[:16]))


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    path = (os.path.join(CUDA_HOME, 'bin', 'nvcc') if CUDA_HOME
            else shutil.which('nvcc'))
    if not path or not os.path.exists(path):
        raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA '
                           'kernels are built on a machine with the CUDA '
                           'toolkit')
    return path


def build(names=None):
    """Compiles the named kernels (default: all) that are not built yet,
    one nvcc process per source, all started together. Returns
    {name: library path}. Raises RuntimeError with nvcc's output if a
    build fails. Each library's compiler output (including ptxas'
    register and shared-memory report) is kept beside it as ``.log``."""
    names = list(SOURCES) if names is None else list(names)
    paths = {name: library_path(name) for name in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = '{}.{}.tmp'.format(paths[name], os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, source_path(name)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        with open(paths[name] + '.log', 'w') as f:
            f.write(out)
        if proc.returncode != 0:
            failures.append('{} (nvcc exit {}):\n{}'.format(
                name, proc.returncode, out))
            continue
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError('CUDA kernel build failed: ' +
                           '\n'.join(failures))
    return paths


def build_log(name):
    """nvcc's output from the build of ``name`` ('' if none kept)."""
    log = library_path(name) + '.log'
    if not os.path.exists(log):
        return ''
    with open(log) as f:
        return f.read()


def load(name):
    """The ctypes library of kernel ``name``, built on first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(build([name])[name])
    return _LOADED[name]
