"""The native KITTI AP evaluator: built from the repo's C++ source and run
at both IoU regimes.

Counterpart of ``compile_kitti_native_code`` and ``run_kitti_native_eval``
in ``monopsr_tpu/eval/evaluator.py`` and of the two scripts they run
(``scripts/offline_eval/kitti_native_eval/run_eval.sh`` and
``run_eval_low_iou.sh``). The JAX package builds the binary with ``make``
beside its source and forks one Python process per script. Here:

- ``build`` compiles ``evaluate_object_3d_offline.cpp`` with the
  Makefile's flags (``g++ -O3 -std=c++17``) into ``build/
  kitti_native_eval/`` at the repository root (listed in .gitignore),
  named by a hash of the source and the flags, at first use. The source
  directory is left as it is.
- ``run`` starts the binary itself with ``subprocess.Popen`` (no fork of
  a process that holds a CUDA context), at the standard regime and then
  with ``low``, and appends to the scripts' results files what they
  append: a ``step N`` line, then the binary's standard output.

The binary also writes its precision-recall curves as text under
``<result_dir>/plot/``; the scripts' last step, PNG plots of those
curves with matplotlib, is not ported (ROADMAP M18).
"""

import hashlib
import os
import shutil
import subprocess
import time

import monopsr_torch

SOURCE = os.path.join(monopsr_torch.top_dir(), 'scripts', 'offline_eval',
                      'kitti_native_eval', 'evaluate_object_3d_offline.cpp')

CXX_FLAGS = ('-O3', '-std=c++17')

BUILD_DIR = os.path.join(monopsr_torch.top_dir(), 'build',
                         'kitti_native_eval')


def binary_path():
    """The binary, named by a hash of its source and flags."""
    digest = hashlib.sha256(' '.join(CXX_FLAGS).encode() + b'\0')
    with open(SOURCE, 'rb') as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, 'evaluate_object_3d_offline-{}'.format(
        digest.hexdigest()[:16]))


def build():
    """Compiles the binary unless it is built already; returns its path.
    Written under a temporary name and renamed, so concurrent builds
    never expose half a file. Raises RuntimeError with the compiler's
    output if the build fails."""
    path = binary_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which('g++')
    if cxx is None:
        raise RuntimeError('g++ not found: the native KITTI evaluator is '
                           'built from ' + SOURCE)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = '{}.{}.tmp'.format(path, os.getpid())
    proc = subprocess.run([cxx, *CXX_FLAGS, '-o', tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError('native KITTI evaluator build failed (g++ exit '
                           '{}):\n{}'.format(proc.returncode, proc.stdout))
    os.replace(tmp, path)
    return path


def results_paths(pred_dir, config_name, score_threshold):
    """The results files of the standard and the low-IoU regime, as
    run_eval.sh and run_eval_low_iou.sh name them."""
    thr = str(round(score_threshold, 3))
    return (os.path.join(pred_dir, '{}_results_{}.txt'.format(
                config_name, thr)),
            os.path.join(pred_dir, '{}_results_low_iou_{}.txt'.format(
                config_name, thr)))


def run(binary, gt_dir, result_dir, global_step, results_files):
    """Evaluates the KITTI files under ``result_dir``/data against the
    labels in ``gt_dir``: the standard regime, then the low one, one
    process at a time (both write the same curve files). Each appends a
    ``step N`` line and the binary's output to its results file (one of
    ``results_paths``) and prints them, then the seconds both took.
    Raises RuntimeError if the binary exits non-zero."""
    t0 = time.perf_counter()
    for extra, results_file in zip(([], ['low']), results_files):
        proc = subprocess.Popen([binary, gt_dir, result_dir] + extra,
                                stdout=subprocess.PIPE, text=True)
        out, _ = proc.communicate()
        text = 'step {}\n{}'.format(int(global_step), out)
        with open(results_file, 'a') as f:
            f.write(text)
        print(text, end='')
        if proc.returncode != 0:
            raise RuntimeError('native KITTI evaluator exited {} on {}'
                               .format(proc.returncode, result_dir))
    print('native eval of step {}: {:.3f} s'.format(
        int(global_step), time.perf_counter() - t0))
