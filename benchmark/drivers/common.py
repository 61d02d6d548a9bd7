"""What the drivers share: the program's config from the cell's, the
reference net over the seed's weights, the control's lower precision,
and the checks against the cell's limits."""

import collections
import contextlib
import copy
import math
import os

from benchmark import weights
from benchmark.reference import train as ref_train

Run = collections.namedtuple('Run', 'context checks attempted failed correct')


def synchronize(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def memory_peak(device):
    """The caching allocator's peak on the card since the process reset
    it; 0 on the CPU (not measured)."""
    import torch
    return torch.cuda.max_memory_allocated(device) if \
        device.type == 'cuda' else 0


def free(device):
    import gc

    import torch
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


def ref_config(cell):
    """The reference's NetConfig of the cell's configuration."""
    return ref_train.net_config(cell.experiment)


def loss_config(cell):
    return cell.experiment['model_config']['loss_config']


def ema_decay(cell):
    opt = cell.experiment['train_config']['optimizer']
    return float(opt[opt['optimizer_type']]['moving_average_decay'])


def program_config(cell, seed, workdir, **dataset):
    """The port's parsed config of the cell: its experiment with the
    mix's train settings and ``dataset`` keys, the dataset seeded from
    ``seed``, written as YAML under ``workdir`` and read by the port's
    reader (outputs under ``workdir``)."""
    from monopsr_torch import config as config_lib
    experiment = copy.deepcopy(cell.experiment)
    experiment['dataset_config']['seed'] = seed % (2 ** 32)
    experiment['dataset_config'].update(dataset)
    experiment['train_config'].update(cell.traffic.get('train_config', {}))
    path = os.path.join(workdir, cell.config['name'] + '.yaml')
    config_lib.dump_yaml(experiment, path)
    return config_lib.parse_yaml_config(path, output_base_dir=workdir)


def make_weights(cfg, seed, device):
    """The seed's weights, by the names and shapes of the reference net."""
    import torch
    from benchmark.reference.monopsr_net import MonoPSRNet
    with torch.device('meta'):
        shapes = MonoPSRNet(cfg)
    return weights.make_state(shapes, seed, device)


def reference_net(cfg, seed, device):
    """(reference net on ``device`` holding the seed's weights, those
    weights)."""
    import torch
    from benchmark.reference.monopsr_net import MonoPSRNet
    with torch.device('meta'):
        net = MonoPSRNet(cfg)
    net = net.to_empty(device=device)
    state = make_weights(cfg, seed, device)
    net.load_state_dict(state)
    return net, state


def lower_precision(net, lower):
    """Makes ``net`` the control: its bfloat16 convolutions round their
    operands to float8 e4m3 (``lower`` 'fp8'); 'tf32' acts through
    ``tf32``; None leaves the reference as it is."""
    from benchmark.reference.resnet import Conv2d
    if lower == 'fp8':
        for module in net.modules():
            if isinstance(module, Conv2d):
                module.lower_precision = 'fp8'


@contextlib.contextmanager
def tf32(on):
    """TF32 for cuBLAS and cuDNN inside the block when ``on`` (the
    control of a float32 configuration); off, as the port sets it,
    otherwise."""
    import torch
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    torch.backends.cudnn.allow_tf32 = bool(on)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def lower_mode(cell):
    """The control's precision step for the cell's configuration."""
    dtype = cell.experiment['model_config'].get('compute_dtype', 'bfloat16')
    return 'fp8' if dtype == 'bfloat16' else 'tf32'


def checks(cell, numbers):
    """[(name, value, limit)] for each number the cell's limits hold."""
    out = []
    for name, value in numbers.items():
        limit = cell.limits.get(name, {}).get('limit')
        if limit is not None:
            out.append((name, value, limit))
    return out


def passed(checks):
    return bool(checks) and all(
        math.isfinite(value) and value <= limit
        for _, value, limit in checks)
