"""monopsr_torch stands alone: no jax, flax, optax or monopsr_tpu, no
host-only libraries, and no quiet fall back to the CPU."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'cv2', 'PIL', 'yaml',
            'sklearn', 'matplotlib', 'monopsr_tpu')

# The JAX system's entry points at the root, which neither the port nor
# chip_smoke.py may import (the port's are experiments.flagship and
# experiments.bench)
_ROOT_ENTRY_POINTS = ('__graft_entry__', 'bench')

# Modules added with the converters, remat, the trainer's hooks, the
# evaluation tools, the drawing helpers, the demos, the M15 tail, the
# bench, the graphed eval step and what it shares with the graphed train
# step
_LATER_MODULES = (
    'tools.convert_tf_resnet', 'tools.convert_torch_resnet',
    'tools.odapi_manifest', 'tools.save_kitti_predictions',
    'utils.profiling', 'utils.summary_images', 'utils.demo_utils',
    'visualization.vis_utils', 'demos.view_kitti_sample_2d',
    'demos.show_jittered_boxes_2d', 'demos.view_instance_masks',
    'core_utils.distance_metrics', 'core_utils.format_checker',
    'core_utils.label_cluster_utils', 'core_utils.instance_metrics',
    'geometry.planes', 'experiments.flagship', 'experiments.bench',
    'eval.step_graph', 'utils.cuda_graph')

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
BLOCKED = {blocked!r}
for name in BLOCKED + {roots!r}:
    sys.modules[name] = None          # any import of these raises
import monopsr_torch
names = ['monopsr_torch'] + [
    m.name for m in pkgutil.walk_packages(monopsr_torch.__path__,
                                          'monopsr_torch.')]
for name in names:
    importlib.import_module(name)
want = {{'monopsr_torch.' + m for m in {later!r}}}
assert {{'monopsr_torch.parallel.data_parallel',
         'monopsr_torch.experiments.accuracy_gate'}} | want <= set(names), \
    sorted(want - set(names))
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED
                and sys.modules[m] is not None)
print(len(names), leaked)
""".format(blocked=_BLOCKED, later=_LATER_MODULES, roots=_ROOT_ENTRY_POINTS)

# Each CLI of the converters, the tools and the demos parses its flags
# with the same modules blocked
_CLI_HELP = r"""
import contextlib, importlib, io, sys
for name in {blocked!r}:
    sys.modules[name] = None
for module in {clis!r}:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            importlib.import_module('monopsr_torch.' + module).main(
                ['--help'])
        except SystemExit as e:
            assert e.code == 0, (module, e.code)
    assert out.getvalue().startswith('usage:'), module
print('ok')
""".format(blocked=_BLOCKED, clis=(
    'tools.convert_tf_resnet', 'tools.convert_torch_resnet',
    'tools.save_kitti_predictions', 'demos.view_kitti_sample_2d',
    'demos.show_jittered_boxes_2d', 'demos.view_instance_masks'))


def test_package_imports_without_jax_or_reference():
    """Every module of the port, the train modules, the config reader,
    the KITTI dataset layer, the evaluator's host side, the three CLIs,
    the data-preparation tools (monopsr_torch.tools), the data-parallel
    ranks (monopsr_torch.parallel), the accuracy gate
    (monopsr_torch.experiments.accuracy_gate), the converters, the
    trainer's hooks, the drawing helpers, the demos, the M15 tail, the
    bench (experiments.flagship and experiments.bench) and the graphed
    eval step (eval.step_graph) included (and
    chip_smoke.py), imports with jax, flax, optax, cv2, PIL, yaml,
    scikit-learn, matplotlib, monopsr_tpu and the JAX system's root
    entry points (__graft_entry__.py, bench.py) made unimportable (the
    drawing helpers and demos import matplotlib when they draw)."""
    out = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, leaked = out.stdout.split(' ', 1)
    assert int(count) >= 61 + len(_LATER_MODULES)
    assert leaked.strip() == '[]'


def test_tool_and_demo_clis_parse_their_flags_without_jax():
    out = subprocess.run([sys.executable, '-c', _CLI_HELP], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_sources_name_no_jax():
    for root, _, files in os.walk(os.path.join(REPO, 'monopsr_torch')):
        for name in files:
            if name.endswith(('.py', '.cu', '.cuh', '.cpp')):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                for banned in ('import jax', 'from jax', 'import flax',
                               'import optax', 'from monopsr_tpu',
                               'import monopsr_tpu', 'import __graft_entry__',
                               'from __graft_entry__'):
                    assert banned not in text, (name, banned)


# The host image library (csrc/image_host.cpp) builds into an empty
# directory and decodes and resizes with the same modules blocked
_HOST_LIBRARY = r"""
import sys
for name in {blocked!r}:
    sys.modules[name] = None
import numpy as np
from monopsr_torch.ops import cuda_build
from monopsr_torch.utils import image_io
cuda_build.HOST_BUILD_DIR = sys.argv[1]
image = image_io.read_png(sys.argv[2])
small = image_io.resize_bilinear_uint8(image, (32, 96))
assert np.array_equal(small, image_io.resize_bilinear_uint8_plain(
    image, (32, 96)))
assert cuda_build.library_path('image_host').startswith(sys.argv[1])
leaked = sorted(m for m in sys.modules if m.split('.')[0] in {blocked!r}
                and sys.modules[m] is not None)
print(image.shape, leaked)
""".format(blocked=_BLOCKED)


def test_host_library_builds_and_loads_without_jax_cv2_or_pil(tmp_path):
    png = os.path.join(REPO, 'tests', 'datasets', 'Kitti', 'object',
                       'training', 'image_2', '000000.png')
    out = subprocess.run([sys.executable, '-c', _HOST_LIBRARY,
                          str(tmp_path), png], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('[]')
    assert any(name.startswith('image_host-') and name.endswith('.so')
               for name in os.listdir(tmp_path))


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    from monopsr_torch.eval import evaluator
    from monopsr_torch.models import monopsr
    from monopsr_torch.models.monopsr_net import NetConfig
    from monopsr_torch.train import optimizer, trainer
    from monopsr_torch.utils import device

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = NetConfig(num_boxes=2, resnet='resnet_tiny',
                    proposal_fc_sizes=(8,), regression_fc_sizes=(8,))
    with pytest.raises(RuntimeError, match='CUDA'):
        device.resolve_device()
    with pytest.raises(RuntimeError, match='CUDA'):
        monopsr.create_net(cfg)
    net = monopsr.create_net(cfg, device='cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        evaluator.make_eval_step(net, cfg, {}, 'val')
    tx, _, _, _ = optimizer.build_optimizer({'optimizer': {
        'optimizer_type': 'gradient_descent_optimizer',
        'gradient_descent_optimizer': {'learning_rate_type': 'constant',
                                       'learning_rate': 0.1}}})
    with pytest.raises(RuntimeError, match='CUDA'):
        trainer.make_train_step(net, cfg, {}, tx, False, None)
    assert device.resolve_device('cpu') == torch.device('cpu')
    with pytest.raises(ValueError):
        evaluator.make_eval_step(net, cfg, {}, 'train', device='cpu')

    # The training loop and its CLI: CUDA unless the CPU is asked for
    from monopsr_torch.config import ConfigObj
    from monopsr_torch.experiments import run_training
    with pytest.raises(RuntimeError, match='CUDA'):
        trainer.train(ConfigObj({}), None)
    production = os.path.join(REPO, 'configs', 'monopsr_model_000.yaml')
    with pytest.raises(RuntimeError, match='CUDA'):
        run_training.main(['--config_path', production])
    with pytest.raises(RuntimeError, match='CUDA'):
        run_training.main(['--config_path', production, '--device', 'cuda'])

    # The evaluator and the evaluation and inference CLIs
    from monopsr_torch.experiments import run_evaluation, run_inference
    with pytest.raises(RuntimeError, match='CUDA'):
        evaluator.Evaluator(ConfigObj({}), None, 'val')
    for cli in (run_evaluation, run_inference):
        with pytest.raises(RuntimeError, match='CUDA'):
            cli.main(['--config_path', production])
        with pytest.raises(RuntimeError, match='CUDA'):
            cli.main(['--config_path', production, '--device', 'cuda'])

    # The accuracy gate and the data-parallel ranks
    from monopsr_torch.experiments import accuracy_gate
    from monopsr_torch.parallel import data_parallel
    with pytest.raises(RuntimeError, match='CUDA'):
        accuracy_gate.main(['--steps', '1'])
    with pytest.raises(RuntimeError, match='CUDA'):
        data_parallel.launch(print, 2, None)


def test_kernel_wrapper_refuses_other_devices():
    from monopsr_torch.ops import emd
    x = torch.zeros(1, 4, 3, device='meta')
    with pytest.raises(ValueError, match='CPU or CUDA'):
        emd.emd_cost_fused(x, x)
    with pytest.raises(ValueError, match='CPU or CUDA'):
        emd.emd_distance(x, x)


def test_resolve_device_sets_the_float32_policy(monkeypatch):
    """TF32 off for cuBLAS and cuDNN, set by the one function every entry
    point passes through when it resolves a CUDA device."""
    from monopsr_torch.utils import device

    def set_flags(value):
        torch.backends.cuda.matmul.allow_tf32 = value
        torch.backends.cudnn.allow_tf32 = value

    def flags():
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)

    before = flags()
    try:
        set_flags(True)
        device.set_float32_precision()
        assert flags() == (False, False)

        set_flags(True)
        assert device.resolve_device('cpu') == torch.device('cpu')
        assert flags() == (True, True)        # the CPU leaves them alone
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
        assert device.resolve_device() == torch.device('cuda')
        assert flags() == (False, False)
    finally:
        set_flags(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]
