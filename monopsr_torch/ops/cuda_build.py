"""Builds the port's native libraries and loads them with ctypes: the
CUDA kernels with nvcc, the host image code with g++.

Each CUDA kernel is one ``csrc/<name>.cu`` with a plain C interface,
compiled for Hopper (``sm_90a``) into a shared library under
``build/monopsr_torch_kernels/`` at the repository root (listed in
.gitignore). The host library (``HOST_SOURCES``: PNG unfiltering and the
8-bit resize of the input pipeline, ``csrc/image_host.cpp``) is C++ for
the CPU, compiled by g++ into ``build/monopsr_torch_host/``; it is built
and used on every machine, the CPU-only ones included. A library's name
carries a hash of its source, of every header beside it that its kind
may include (``*.cuh`` for the kernels) and of the flags, so an edited
source or header is rebuilt and an unchanged one is reused. A build
writes under a per-process temporary name and renames it into place, so
concurrent processes may build the same library. Nothing is built or
loaded at import time: the first call to ``load`` builds.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_ROOT = os.path.join(os.path.dirname(_PACKAGE_DIR), 'build')

# Kernel name -> source under the package
SOURCES = {
    'emd_cost_fused': os.path.join('csrc', 'emd_cost_fused.cu'),
    'emd_loss': os.path.join('csrc', 'emd_loss.cu'),
    'multi_tensor_adam': os.path.join('csrc', 'multi_tensor_adam.cu'),
}

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

BUILD_DIR = os.path.join(_BUILD_ROOT, 'monopsr_torch_kernels')

# Host library name -> source under the package (g++; no fast math, so
# the integer and byte arithmetic is the plain numpy versions' exactly)
HOST_SOURCES = {
    'image_host': os.path.join('csrc', 'image_host.cpp'),
}

HOST_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC')

HOST_BUILD_DIR = os.path.join(_BUILD_ROOT, 'monopsr_torch_host')

_LOADED = {}
_LOAD_LOCK = threading.Lock()    # one build per library per process


def _recipe(name):
    """(source path, flags, build directory, header pattern or None,
    compiler lookup) of library ``name``."""
    if name in HOST_SOURCES:
        return (os.path.join(_PACKAGE_DIR, HOST_SOURCES[name]), HOST_FLAGS,
                HOST_BUILD_DIR, None, _gxx)
    return (os.path.join(_PACKAGE_DIR, SOURCES[name]), NVCC_FLAGS,
            BUILD_DIR, '*.cuh', _nvcc)


def source_path(name):
    return _recipe(name)[0]


def library_path(name):
    """The library ``name``, named by a hash of its source, the headers
    in the source's directory that its kind may include (any of them may
    be) and the flags."""
    source, flags, build_dir, pattern, _ = _recipe(name)
    digest = hashlib.sha256(' '.join(flags).encode())
    headers = sorted(glob.glob(os.path.join(os.path.dirname(source),
                                            pattern))) if pattern else []
    for path in [source] + headers:
        with open(path, 'rb') as f:
            digest.update(os.path.basename(path).encode() + b'\0' +
                          f.read())
    return os.path.join(build_dir, '{}-{}.so'.format(
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


def _gxx():
    path = shutil.which('g++')
    if path is None:
        raise RuntimeError('g++ not found: the host image library is built '
                           'from ' + source_path('image_host'))
    return path


def build(names=None):
    """Compiles the named libraries (default: every CUDA kernel) that are
    not built yet, one compiler process per source, all started together.
    Returns {name: library path}. Raises RuntimeError with the compiler's
    output if a build fails. Each library's compiler output (for a kernel
    ptxas' register and shared-memory report) is kept beside it as
    ``.log``."""
    names = list(SOURCES) if names is None else list(names)
    paths = {name: library_path(name) for name in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    procs = {}
    for name in todo:
        source, flags, build_dir, _, compiler = _recipe(name)
        os.makedirs(build_dir, exist_ok=True)
        cxx = compiler()
        tmp = '{}.{}.tmp'.format(paths[name], os.getpid())
        procs[name] = (cxx, tmp, subprocess.Popen(
            [cxx, *flags, '-o', tmp, source], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (cxx, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        with open(tmp + '.log', 'w') as f:
            f.write(out)
        os.replace(tmp + '.log', paths[name] + '.log')
        if proc.returncode != 0:
            failures.append('{} ({} exit {}):\n{}'.format(
                name, os.path.basename(cxx), proc.returncode, out))
            continue
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError('native library build failed: ' +
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
    """The ctypes library ``name``, built on first use. ``ctypes.CDLL``
    releases the interpreter lock for the length of each call."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOAD_LOCK:
            if name not in _LOADED:
                _LOADED[name] = ctypes.CDLL(build([name])[name])
            lib = _LOADED[name]
    return lib
