"""Every module of the JAX package has its counterpart in the port, and
every public name of a module its counterpart name.

Each ``monopsr_tpu/**/*.py`` must have a module at the same relative path
under ``monopsr_torch/``, or an entry in ``NO_COUNTERPART`` below saying
which part of the port takes its role and why there is no file of that
name. A JAX module with neither fails the test, and so does an entry for
a module that no longer exists or that has a counterpart after all.

Within a module that has its counterpart, each public top-level name of
the JAX module (a function, a class or an assigned name, read with
``ast``; not a name it imports) must be defined at the top level of the
port module, or have an entry in ``NAME_REASONS`` saying where the port
keeps it or why it has none. An entry for a name that the port defines
after all, or that the JAX module no longer has, fails too.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, 'monopsr_tpu')
PORT_ROOT = os.path.join(REPO, 'monopsr_torch')

# JAX module -> what covers its role in the port, and why no file of
# that name exists
NO_COUNTERPART = {
    'utils/transfer.py':
        'eval/pipeline.py copies each tensor to pinned host memory and '
        'waits on one event per tensor; the packed device-to-host '
        'transfers worked around a slow remote TPU link',
    'utils/compile_cache.py':
        'there is no XLA compilation to cache: torch runs eagerly and the '
        'CUDA kernels are built once per source hash by ops/cuda_build.py',
    'utils/device_select.py':
        'utils/device.py resolves the device (CUDA unless the CPU is asked '
        'for) and counts the visible cards',
    'tools/ip_basic.py':
        'ops/depth_fill.py is the depth completion in torch, which '
        'tools/gen_depth_maps.py runs on the card; the cv2 version was '
        'the reference the JAX fill was tested against',
    'parallel/mesh.py':
        'parallel/data_parallel.py: one process per card in a process '
        'group, in place of a device mesh in one process',
}


# 'module:name' -> where the port keeps the JAX module's public name, or
# why it has none
NAME_REASONS = {
    '__init__.py:scripts_dir':
        'the port reads the native evaluator\'s sources under '
        'top_dir()/scripts (eval/native_eval.py); the JAX package asks '
        'scripts_dir() for them in one place',
    'constants.py:OUT_DIR_MASKS':
        'a config key that no module of the JAX package reads (it is '
        'only defined there), so the port has nothing to name it for',
    'datasets/kitti/kitti_dataset.py:DEPTH_PAD_SHAPE':
        'moved to constants.py, which the dataset module imports it from',
    'datasets/kitti/kitti_dataset.py:SAMPLE_CEN_Y_OFFSETS':
        'moved to constants.py with the other sample keys',
    'datasets/kitti/kitti_dataset.py:SAMPLE_INSTANCE_IMAGE':
        'moved to constants.py with the other sample keys',
    'datasets/kitti/kitti_dataset.py:SAMPLE_INSTANCE_INDICES':
        'moved to constants.py with the other sample keys',
    'train/optimizer.py:masked_apply_if_finite':
        'an optax wrapper; Optimizer.update with skip_nonfinite applies its '
        'rule (tests/test_torch_optimizer.py holds it to this function)',
    'train/trainer.py:create_checkpoint_manager':
        'trainer.CheckpointManager(directory, max_to_keep), the Orbax '
        'manager\'s counterpart',
    'train/trainer.py:stack_samples':
        'eval/evaluator.py stack_samples, which the trainer and the '
        'evaluator share',
    'utils/prefetch.py:StageTimes':
        'no module of the JAX package uses it; eval/pipeline.py measures '
        'the feed and inference times of each image itself',
}


def _public_names(path):
    """The public top-level functions, classes and assigned names of a
    module (not the names it imports)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
    return {name for name in names if not name.startswith('_')}


def _jax_modules():
    out = []
    for base, _, files in os.walk(JAX_ROOT):
        for name in files:
            if name.endswith('.py'):
                out.append(os.path.relpath(os.path.join(base, name),
                                           JAX_ROOT).replace(os.sep, '/'))
    return sorted(out)


@pytest.mark.parametrize('module', _jax_modules())
def test_jax_module_has_a_port_counterpart_or_a_reason(module):
    ported = os.path.exists(os.path.join(PORT_ROOT, module))
    if module in NO_COUNTERPART:
        assert not ported, (
            '{} is ported; remove its NO_COUNTERPART entry'.format(module))
        assert NO_COUNTERPART[module].strip()
    else:
        assert ported, ('monopsr_tpu/{} has no monopsr_torch/{} and no '
                        'NO_COUNTERPART entry'.format(module, module))


def test_every_entry_names_a_jax_module():
    assert sorted(set(NO_COUNTERPART) - set(_jax_modules())) == []


@pytest.mark.parametrize('module', [m for m in _jax_modules()
                                    if m not in NO_COUNTERPART])
def test_jax_module_names_have_port_counterparts_or_reasons(module):
    jax_names = _public_names(os.path.join(JAX_ROOT, module))
    port_names = _public_names(os.path.join(PORT_ROOT, module))
    missing = sorted(name for name in jax_names - port_names
                     if '{}:{}'.format(module, name) not in NAME_REASONS)
    assert missing == [], (
        'monopsr_tpu/{} names {} that monopsr_torch/{} does not define and '
        'NAME_REASONS does not explain'.format(module, missing, module))
    for key, reason in NAME_REASONS.items():
        entry_module, name = key.split(':')
        if entry_module == module:
            assert name in jax_names, '{}: no longer in JAX'.format(key)
            assert name not in port_names, (
                '{} is ported; remove its NAME_REASONS entry'.format(key))
            assert reason.strip()


def test_every_name_reason_names_a_module_with_a_counterpart():
    modules = {key.split(':')[0] for key in NAME_REASONS}
    assert sorted(modules - set(_jax_modules())) == []
    assert sorted(modules & set(NO_COUNTERPART)) == []
