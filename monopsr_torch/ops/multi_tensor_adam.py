"""The train step's clip, Adam, apply-if-finite, parameter add and EMA as
hand-written multi-tensor passes on a CUDA device.

``adam_update`` launches the three kernels of ``csrc/multi_tensor_adam.cu``
(a norm pass, a one-block finalize, the update pass) over every tensor of
the parameter list, in place, with no number read on the host; its plain
twin is ``train.optimizer.Optimizer.apply_plain`` (the ``_foreach``
chain), which the CPU runs and the card tests hold it against.

The kernels walk a chunk table: each tensor cut into rows of (tensor,
start, length) of at most ``CHUNK`` elements (``chunk_table``), beside the
device pointers of each tensor's gradient, parameter, moments and EMA
(``device_table``). The table is built on the host from ``data_ptr()``s
at every call. Eagerly it goes to the device through pinned memory in
the stream's order (gradients move from step to step). Under a CUDA
graph's capture it is written once, before the call returns, into a
device buffer of its own outside PyTorch's allocator (a buffer of the
graph's pool may be an earlier tensor's, which each replay writes
again); ``kept``, a list of the caller's, holds it (``CapturedTable``)
as long as the caller lives, and the graph's replays read it there.

``adam_update.launches`` counts the kernel launches (three a call; a
captured launch counts once, at capture).
"""

import ctypes

import numpy as np
import torch

from monopsr_torch.ops import cuda_build

# Elements of a chunk: a multiple of the kernels' 256 threads x 4
CHUNK = 16384

_INT32_LIMIT = 2 ** 31


class AdamHyper(ctypes.Structure):
    """The kernels' constants (``struct AdamHyper`` of the source), each
    float rounded to float32 as the plain twin rounds it."""

    _fields_ = [('clip', ctypes.c_float), ('skip_nonfinite', ctypes.c_int),
                ('max_errors', ctypes.c_int), ('lr_type', ctypes.c_int),
                ('lr', ctypes.c_float), ('decay_steps', ctypes.c_float),
                ('decay_rate', ctypes.c_float), ('staircase', ctypes.c_int),
                ('b1', ctypes.c_float), ('b2', ctypes.c_float),
                ('mu_decay', ctypes.c_float), ('nu_decay', ctypes.c_float),
                ('one_minus_b1', ctypes.c_float),
                ('one_minus_b2', ctypes.c_float), ('eps', ctypes.c_float),
                ('ema_decay', ctypes.c_float),
                ('one_minus_ema', ctypes.c_float)]


def chunk_table(numels, chunk=CHUNK):
    """(n, 3) int64 rows (tensor index, start, length) that cover every
    element of tensors of ``numels`` elements exactly once, in order: each
    tensor cut into runs of ``chunk`` elements and a shorter last one; an
    empty tensor has no row."""
    numels = np.asarray(numels, np.int64).reshape(-1)
    per = (numels + chunk - 1) // chunk
    tensor = np.repeat(np.arange(numels.size, dtype=np.int64), per)
    first = np.repeat(np.cumsum(per) - per, per)
    start = (np.arange(tensor.size, dtype=np.int64) - first) * chunk
    length = np.minimum(chunk, numels[tensor] - start)
    return np.stack([tensor, start, length], axis=1)


def device_table(pointers, numels, chunk=CHUNK):
    """The kernels' table as int64 words: ``pointers`` (five lists of
    device addresses, one per tensor: g, p, mu, nu and ema, 0 where there
    is none), padded to an even count, then one row (tensor, start,
    length, 0) of int32 per chunk. Returns (words, number of chunks)."""
    rows = chunk_table(numels, chunk)
    ptrs = np.zeros(len(pointers) * len(numels) + 1, np.uint64)
    for k, column in enumerate(pointers):
        ptrs[k * len(numels):(k + 1) * len(numels)] = column
    ptrs = ptrs[:len(ptrs) & ~1]
    packed = np.zeros((len(rows), 4), np.int32)
    packed[:, :3] = rows
    words = np.concatenate([ptrs.view(np.int64),
                            packed.view(np.int64).reshape(-1)])
    return words, len(rows)


def _lib():
    lib = cuda_build.load('multi_tensor_adam')
    launch = lib.multi_tensor_adam_launch
    launch.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 +
                       [AdamHyper, ctypes.c_void_p])
    launch.restype = ctypes.c_int
    create = lib.multi_tensor_adam_table_create
    create.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                       ctypes.c_size_t]
    create.restype = ctypes.c_int
    lib.multi_tensor_adam_table_destroy.argtypes = [ctypes.c_void_p]
    lib.multi_tensor_adam_table_destroy.restype = ctypes.c_int
    lib.multi_tensor_adam_num_scalars.restype = ctypes.c_int
    lib.multi_tensor_adam_error_string.argtypes = [ctypes.c_int]
    lib.multi_tensor_adam_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError('multi_tensor_adam {} failed: {}'.format(
            what, lib.multi_tensor_adam_error_string(err).decode()))


class CapturedTable:
    """A table on the device outside PyTorch's allocator, written from
    the host ``words`` at once (``multi_tensor_adam_table_create``), for
    a captured update; freed with the object."""

    def __init__(self, lib, words):
        self._lib = lib
        self.ptr = ctypes.c_void_p()
        _raise_on(lib, lib.multi_tensor_adam_table_create(
            ctypes.byref(self.ptr), words.ctypes.data, words.nbytes),
            'table upload')

    def data_ptr(self):
        return self.ptr.value

    def __del__(self):
        if self.ptr.value:
            self._lib.multi_tensor_adam_table_destroy(self.ptr)
            self.ptr = ctypes.c_void_p()


def _check(lists, counters, device):
    """Raises unless every tensor lies on ``device`` (a CUDA device) and
    is contiguous, g, p, nu and ema float32, mu float32 or bfloat16
    throughout, each tensor's set of the same shape and under 2**31
    elements, the counters int32 (``last_finite`` bool) scalars."""
    if device.type != 'cuda':
        raise ValueError('the multi-tensor Adam kernels run on a CUDA '
                         'device, got {}'.format(device))
    mu_dtype = lists['mu'][0].dtype if lists['mu'] else torch.float32
    if mu_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError('mu is stored in float32 or bfloat16 for the '
                        'kernels, got {}'.format(mu_dtype))
    for key, tensors in lists.items():
        want = mu_dtype if key == 'mu' else torch.float32
        for i, t in enumerate(tensors):
            if t.device != device:
                raise ValueError('{}[{}] lies on {}, the update runs on '
                                 '{}'.format(key, i, t.device, device))
            if t.dtype != want:
                raise TypeError('{}[{}] is {}, want {}'.format(
                    key, i, t.dtype, want))
            if not t.is_contiguous():
                raise ValueError('{}[{}] is not contiguous'.format(key, i))
            if t.shape != lists['p'][i].shape:
                raise ValueError('{}[{}] has shape {}, its parameter {}'
                                 .format(key, i, tuple(t.shape),
                                         tuple(lists['p'][i].shape)))
            if t.numel() >= _INT32_LIMIT:
                raise ValueError('{}[{}] has 2**31 elements or more'.format(
                    key, i))
    for name, t in counters.items():
        want = torch.bool if name == 'last_finite' else torch.int32
        if t.device != device or t.dtype != want or t.numel() != 1:
            raise ValueError('{} must be one {} on {}, got {} {} on {}'
                             .format(name, want, device, t.numel(), t.dtype,
                                     t.device))


def adam_update(grads, params, mu, nu, count, hyper, kept, counters=None,
                ema=None):
    """One optimizer update over the parameter list, in place, on the
    current stream of the parameters' CUDA device: the global norm and
    finite check of ``grads``, the apply-if-finite counters (``counters``:
    {'notfinite_count', 'last_finite', 'total_notfinite'}, None without
    it), the clip, Adam into ``mu`` and ``nu``, ``count``, the parameter
    add into ``params`` and, with ``ema``, the EMA (lists of tensors, one
    per parameter, in one order). ``hyper``: an ``AdamHyper``. ``kept``: a
    list its owner keeps, which holds each table a captured graph reads.
    Raises on a tensor the kernels do not take (``_check``)."""
    lists = {'g': list(grads), 'p': list(params), 'mu': list(mu),
             'nu': list(nu)}
    if ema is not None:
        lists['ema'] = list(ema)
    counters = dict(counters or {})
    device = count.device
    _check(lists, dict(counters, count=count), device)
    if bool(hyper.skip_nonfinite) != bool(counters):
        raise ValueError('apply-if-finite needs its three counters, and '
                         'only it')
    lib = _lib()
    numels = [t.numel() for t in lists['p']]
    pointers = [[t.data_ptr() for t in lists[key]] if key in lists
                else [0] * len(numels)
                for key in ('g', 'p', 'mu', 'nu', 'ema')]
    words, n_chunks = device_table(pointers, numels)
    with torch.cuda.device(device):
        if torch.cuda.is_current_stream_capturing():
            table = CapturedTable(lib, words)
            kept.append(table)
        else:
            table = torch.from_numpy(words).pin_memory().to(
                device, non_blocking=True)
        # float64 sums and int32 flags per chunk, then the scalar block
        scratch = torch.empty(
            12 * n_chunks + 4 * lib.multi_tensor_adam_num_scalars(),
            dtype=torch.uint8, device=device)
        base = scratch.data_ptr()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.multi_tensor_adam_launch(
            table.data_ptr(), len(numels), n_chunks,
            int(lists['mu'][0].dtype == torch.bfloat16) if numels else 0,
            int(ema is not None), base, base + 8 * n_chunks,
            base + 12 * n_chunks, count.data_ptr(),
            *[counters[k].data_ptr() if counters else None
              for k in ('notfinite_count', 'last_finite', 'total_notfinite')],
            hyper, stream)
    _raise_on(lib, err, 'launch')
    adam_update.launches += 3


adam_update.launches = 0
