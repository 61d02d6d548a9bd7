"""Every module of the JAX package has its counterpart in the port.

Each ``monopsr_tpu/**/*.py`` must have a module at the same relative path
under ``monopsr_torch/``, or an entry in ``NO_COUNTERPART`` below saying
which part of the port takes its role and why there is no file of that
name. A JAX module with neither fails the test, and so does an entry for
a module that no longer exists or that has a counterpart after all.
"""

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
