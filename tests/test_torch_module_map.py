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

The JAX system's entry points outside its package are held the same
way: each Python file at the repository's root that imports JAX or the
JAX package, and the scripts named in ``ENTRY_POINTS``, must map there
to a module of the port, whose public names are checked against
``ENTRY_NAME_REASONS`` as a package module's are against
``NAME_REASONS``.
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
        'the compiled steps\' counterparts are CUDA graphs captured in '
        'each process (eval/step_graph.py, train/step_graph.py); only the '
        'cache of compiled programs across processes has none, and the '
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
        'utils/profiling.py StageTimes, the program\'s recorder of spans '
        'and counters, of which the evaluator\'s stage totals are a part',
    'utils/profiling.py:StepTimer':
        'a rolling steps-per-second timer that nothing in the port read; '
        'the graphed train step\'s spans (StageTimes) time its dispatches',
}


# Port modules with no module of that path in the JAX package (and not an
# entry point's counterpart, ENTRY_POINTS) -> the JAX construct or file
# they stand for, or why the port needs them
PORT_ONLY = {
    'demos/__init__.py':
        'the package of the demos, which the JAX system keeps at the '
        'repository root (demos/)',
    'demos/show_jittered_boxes_2d.py': 'demos/show_jittered_boxes_2d.py',
    'demos/view_instance_masks.py': 'demos/view_instance_masks.py',
    'demos/view_kitti_sample_2d.py': 'demos/view_kitti_sample_2d.py',
    'eval/native_eval.py':
        'the native KITTI AP evaluator (scripts/offline_eval), which the '
        'JAX evaluator builds with make and runs in a forked process',
    'eval/step_graph.py':
        'the JAX evaluator\'s compiled eval step, jax.jit(eval_step, '
        'static_argnums=2) in eval/evaluator.py: one CUDA graph of the '
        'eval step per Evaluator, replayed for every group',
    'ops/cuda_build.py':
        'builds the hand-written CUDA kernels that stand for the Pallas '
        'kernels, and the host image library; Pallas compiles within XLA',
    'ops/multi_tensor_adam.py':
        'optax\'s clip_by_global_norm -> adam -> apply_if_finite chain and '
        'the EMA (train/optimizer.py, train/train_state.py), which XLA '
        'fuses into the jitted train step: the hand-written kernels that '
        'run them as two passes on the card',
    'parallel/data_parallel.py':
        'one process per card in a process group, in place of the device '
        'mesh of parallel/mesh.py',
    'tools/save_kitti_predictions.py':
        'scripts/offline_eval/save_kitti_predictions.py',
    'train/step_graph.py':
        'the JAX trainer\'s steps_per_dispatch program, a lax.scan of K '
        'train steps in train/trainer.py: K replays of a CUDA graph',
    'utils/cuda_graph.py':
        'what the counterparts of the JAX package\'s compiled train and '
        'eval steps share (eval/step_graph.py, train/step_graph.py): the '
        'side stream, the capture and the static input buffers',
    'utils/device.py':
        'utils/device_select.py and the precision policy JAX sets by '
        'default: the device (CUDA unless the CPU is asked for), TF32 off',
    'utils/grids.py':
        'jnp.linspace\'s rounding, which torch.linspace does not share, '
        'for the crop, resize and projection grids',
    'utils/image_io.py':
        'cv2.imread, cv2.imwrite and cv2.resize, which the JAX package '
        'calls and the card\'s machine does not have',
    'weights.py':
        'moves flax variables into the port\'s modules, for the parity '
        'tests and the converters',
}


# The JAX system's entry points outside monopsr_tpu/ -> their counterpart
# under monopsr_torch/
ENTRY_POINTS = {
    'bench.py': 'experiments/bench.py',
    '__graft_entry__.py': 'experiments/flagship.py',
    'scripts/bench_ops.py': 'experiments/bench.py',
    'scripts/accuracy_gate.py': 'experiments/accuracy_gate.py',
}

# 'entry point:name' -> where the port keeps the name, or why it has none
ENTRY_NAME_REASONS = {
    'bench.py:BASELINE_FPS':
        'the reference paper\'s ~5 frames/s on a desktop GPU of 2019; the '
        'port\'s bench reports its own rates on the H100 and compares '
        'with nothing taken elsewhere',
    'bench.py:V5E_BF16_PEAK_FLOPS':
        'the peak of a TPU v5e; the port measures against one H100 SXM, '
        'H100_BF16_PEAK_FLOPS',
    'bench.py:bench_train_step_scanned':
        'K steps in one lax.scan program; the port\'s counterpart is '
        'bench_train_step_graphed, K replays of a CUDA graph of the step '
        '(train/step_graph.py) per host dispatch',
    'bench.py:best_of':
        'the port reports every timed reading as the median and quartiles '
        'of its repeats (utils/profiling.spread), not the best pass',
    'bench.py:measure_d2h_mbps':
        'the device-to-host rate of the remote TPU link, which bounded the '
        'JAX bench\'s e2e rate; the card\'s copies are in the e2e pull '
        'stage',
    'scripts/bench_ops.py:B':
        'the kernels reading takes its shapes from the config: boxes '
        '(num_boxes) for K2 and Chamfer, eval batch x boxes for K1',
    'scripts/bench_ops.py:N':
        'the kernels reading takes its points from the config\'s ROI '
        '(map_roi_size: 48 x 48 = 2304)',
    '__graft_entry__.py:DRYRUN_LOSS_CONFIG':
        'flagship.loss_config() reads the loss config from the YAML, where '
        'the JAX entry keeps a copy of it',
    '__graft_entry__.py:dryrun_multichip':
        'parallel/data_parallel.py runs the ranks, and chip_smoke.py phase '
        '14 checks two of them against one process on the card',
}


def _imports_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [alias.name.split('.')[0] for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots = [node.module.split('.')[0]]
        else:
            continue
        if {'jax', 'monopsr_tpu'} & set(roots):
            return True
    return False


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


def test_root_entry_points_of_the_jax_system_are_mapped():
    roots = sorted(name for name in os.listdir(REPO)
                   if name.endswith('.py') and
                   _imports_jax(os.path.join(REPO, name)))
    assert roots, 'no JAX entry point at the root'
    assert sorted(set(roots) - set(ENTRY_POINTS)) == [], (
        'a JAX entry point at the root has no ENTRY_POINTS counterpart')


@pytest.mark.parametrize('entry', sorted(ENTRY_POINTS))
def test_entry_point_names_have_port_counterparts_or_reasons(entry):
    port = os.path.join(PORT_ROOT, ENTRY_POINTS[entry])
    assert _imports_jax(os.path.join(REPO, entry))
    assert os.path.exists(port), port
    jax_names = _public_names(os.path.join(REPO, entry))
    port_names = _public_names(port)
    missing = sorted(name for name in jax_names - port_names
                     if '{}:{}'.format(entry, name) not in
                     ENTRY_NAME_REASONS)
    assert missing == [], (
        '{} names {} that monopsr_torch/{} does not define and '
        'ENTRY_NAME_REASONS does not explain'.format(
            entry, missing, ENTRY_POINTS[entry]))
    for key, reason in ENTRY_NAME_REASONS.items():
        entry_point, name = key.split(':')
        if entry_point == entry:
            assert name in jax_names, '{}: no longer there'.format(key)
            assert name not in port_names, (
                '{} is ported; remove its ENTRY_NAME_REASONS entry'.format(
                    key))
            assert reason.strip()


def test_every_entry_name_reason_names_an_entry_point():
    assert sorted({key.split(':')[0] for key in ENTRY_NAME_REASONS} -
                  set(ENTRY_POINTS)) == []


def _port_modules():
    out = []
    for base, _, files in os.walk(PORT_ROOT):
        for name in files:
            if name.endswith('.py'):
                out.append(os.path.relpath(os.path.join(base, name),
                                           PORT_ROOT).replace(os.sep, '/'))
    return sorted(out)


def _port_only_modules():
    return [m for m in _port_modules()
            if not os.path.exists(os.path.join(JAX_ROOT, m)) and
            m not in ENTRY_POINTS.values()]


@pytest.mark.parametrize('module', _port_only_modules())
def test_port_only_module_names_what_it_stands_for(module):
    assert module in PORT_ONLY, (
        'monopsr_torch/{} has no monopsr_tpu/{}, is no entry point\'s '
        'counterpart and has no PORT_ONLY entry'.format(module, module))
    assert PORT_ONLY[module].strip()


def test_every_port_only_entry_names_a_port_only_module():
    assert sorted(set(PORT_ONLY) - set(_port_only_modules())) == []
