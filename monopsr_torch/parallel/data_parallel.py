"""Data parallelism over ranks: one process per card, one global batch.

Counterpart of ``monopsr_tpu/parallel/mesh.py``. The JAX package shards
the image axis of each step over a 1-D 'data' mesh inside one process,
and ``jit`` inserts the collectives. Here each rank is a process of its
own with its own device, started by ``launch``; the collectives are
written out where the step needs them:

- ``shard_rows``: the rank's rows of a global batch (JAX ``shard_batch``);
- ``replicate``: rank 0's tensors broadcast to every rank (JAX
  ``replicate``), so weights and optimizer state start identical;
- ``mean_over_ranks``: the mean over ranks of a tensor list (gradients,
  logged losses), in place;
- ``sum_over_ranks``: the sum over ranks of one tensor, with its gradient
  flowing back to every rank (the decoder's batch statistics);
- ``gather_rows``: every rank's rows concatenated in rank order;
- ``all_gather_objects``: every rank's picklable list, concatenated;
- ``broadcast_object``: rank 0's picklable value on every rank.

Without a process group (one process, as with one card) every helper is
the identity: ``world_size()`` is 1 and nothing is communicated.

The group runs NCCL when each rank has a card of its own, and gloo
otherwise: on the CPU, or with several ranks on one card (gloo takes
CUDA tensors). Ranks are started with the ``spawn`` method: a process
holding a CUDA context must not fork.
"""

import socket

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from monopsr_torch.utils import device as device_lib


def world_size():
    """Ranks in the process group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank():
    """This process's rank; 0 without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main():
    """Whether this process is rank 0, the one that writes files."""
    return rank() == 0


def clamped_ranks(requested, device):
    """The ranks a config's ``data_parallel`` (or ``eval_data_parallel``)
    asks for, clamped to the visible devices as JAX clamps its mesh: 1 on
    the CPU and on one card."""
    return min(int(requested or 1), device_lib.visible_device_count(device))


def require_ranks(requested, device, key):
    """Raises ValueError when ``clamped_ranks`` is above 1 and this
    process is not one of the ranks ``launch`` starts."""
    wanted = clamped_ranks(requested, device)
    if wanted > 1 and world_size() == 1:
        raise ValueError(
            '{} {} over the visible devices runs in {} ranks: start them '
            'with monopsr_torch.parallel.data_parallel.launch (the CLIs '
            'do)'.format(key, int(requested), wanted))


def backend_for(device, num_ranks):
    """'nccl' when each of ``num_ranks`` ranks gets a card of its own,
    'gloo' otherwise (the CPU, or ranks sharing a card)."""
    if device.type == 'cuda' and torch.cuda.device_count() >= num_ranks:
        return 'nccl'
    return 'gloo'


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _run_rank(index, fn, num_ranks, backend, device, port, args):
    """One rank's process: its device and float32 policy (its share of
    the host's cores on the CPU), the group, then ``fn(device, *args)``."""
    device = device_lib.resolve_device(
        device_lib.rank_device(device, index, num_ranks))
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(max(1, torch.get_num_threads() // num_ranks))
    dist.init_process_group(
        backend, init_method='tcp://127.0.0.1:{}'.format(port),
        world_size=num_ranks, rank=index)
    try:
        fn(device, *args)
    finally:
        dist.destroy_process_group()


def launch(fn, num_ranks, device, *args):
    """Runs ``fn(rank_device, *args)`` in ``num_ranks`` spawned processes
    joined in one process group, and waits for all of them. ``fn`` and
    ``args`` are pickled (``fn`` must be a module-level function). Rank r
    runs on ``cuda:r`` when each rank has a card (NCCL), else on
    ``device`` itself (gloo). Raises if any rank fails; the others are
    stopped."""
    device = device_lib.resolve_device(device)
    mp.start_processes(
        _run_rank,
        args=(fn, num_ranks, backend_for(device, num_ranks), str(device),
              _free_port(), args),
        nprocs=num_ranks, join=True, start_method='spawn')


def shard_rows(batch):
    """This rank's rows of a global batch: a dict of arrays or tensors
    whose leading axis is ``world_size()`` equal shares, in rank order."""
    n = world_size()
    if n == 1:
        return batch
    out = {}
    for key, value in batch.items():
        rows = value.shape[0]
        if rows % n:
            raise ValueError('{}: {} rows over {} ranks'.format(key, rows, n))
        share = rows // n
        out[key] = value[rank() * share:(rank() + 1) * share]
    return out


def _coalesced(tensors, op):
    """Runs ``op(flat)`` on one flat buffer per dtype holding ``tensors``
    and copies the result back (bool travels as uint8)."""
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for dtype, group in groups.items():
        wire = torch.uint8 if dtype == torch.bool else dtype
        flat = torch.cat([t.detach().reshape(-1).to(wire) for t in group])
        op(flat)
        offset = 0
        with torch.no_grad():
            for t in group:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view(t.shape).to(dtype))
                offset += n


def replicate(tensors):
    """Broadcasts rank 0's values of ``tensors`` into every rank's, in
    place."""
    if world_size() > 1:
        _coalesced(list(tensors), lambda flat: dist.broadcast(flat, 0))


def mean_over_ranks(tensors):
    """Replaces each tensor of ``tensors`` by its mean over ranks, in
    place; every rank ends with the same values."""
    n = world_size()
    if n > 1:
        def mean(flat):
            dist.all_reduce(flat)
            flat.div_(n)
        _coalesced(list(tensors), mean)


class _SumOverRanks(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        # every rank's objective reads the sum, so each rank's input
        # gets the sum over ranks of the gradients
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def sum_over_ranks(x):
    """The sum over ranks of ``x``, differentiable: the gradient reaching
    each rank's ``x`` is the sum over ranks of the sum's gradients, which
    is the gradient of the sum of the ranks' objectives."""
    if world_size() == 1:
        return x
    return _SumOverRanks.apply(x)


def gather_rows(tensors):
    """Every rank's tensors concatenated on the leading axis in rank
    order, for each tensor of the list (equal shapes on every rank)."""
    n = world_size()
    if n == 1:
        return list(tensors)
    out = []
    for t in tensors:
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(wire) for _ in range(n)]
        dist.all_gather(parts, wire)
        out.append(torch.cat(parts).to(t.dtype))
    return out


def all_gather_objects(items):
    """Every rank's list ``items`` (picklable) concatenated in rank
    order, on every rank."""
    if world_size() == 1:
        return list(items)
    parts = [None] * world_size()
    dist.all_gather_object(parts, list(items))
    return [item for part in parts for item in part]


def broadcast_object(value):
    """Rank 0's ``value`` (picklable) on every rank."""
    if world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, 0)
    return box[0]
