"""Converts a TF Object-Detection-API ResNet checkpoint to the NPZ trunk format.

Counterpart of ``monopsr_tpu/tools/convert_tf_resnet.py``, with the same
reader, name map, flags and NPZ (bitwise, tests/test_torch_converters.py).
The reference initializes BOTH feature towers from the TF OD-API
``faster_rcnn_resnet101_kitti_2018_01_28`` checkpoint via a variable-scope
remap (ref: src/monopsr/core/checkpoint_utils.py:64-117). This tool does
the offline half of that contract: it reads the TF checkpoint directly
(no TensorFlow: the checkpoint V2 "bundle" format is parsed below), maps
slim variable names to the JAX package's flat 'scope/leaf' keys and
writes ``data/pretrained/<name>.npz``, which
``train.pretrained.load_npz_into_towers`` loads into both towers.

Name mapping (slim -> NPZ), applied after stripping any scope prefix up
to and including ``resnet_v1_<depth>/``:

    conv1/weights                                   -> conv1/kernel
    conv1/BatchNorm/{gamma,beta}                    -> conv1_bn/{scale,bias}
    conv1/BatchNorm/moving_{mean,variance}          -> conv1_bn/{mean,var}
    blockL/unit_U/bottleneck_v1/convK/weights       -> blockL_unitU/convK/kernel
    blockL/unit_U/bottleneck_v1/convK/BatchNorm/*   -> blockL_unitU/bnK/*
    blockL/unit_U/bottleneck_v1/shortcut/weights    -> blockL_unitU/shortcut/kernel
    blockL/unit_U/bottleneck_v1/shortcut/BatchNorm/* -> blockL_unitU/shortcut_bn/*

slim stores conv kernels as HWIO, the NPZ's layout, so values transfer
without transposition (``weights.from_flax_variables`` makes them OIHW
when they are loaded). Both slim's resnet_v1 blocks and ``ResNetV1`` put
the projection shortcut on unit 1 and the nominal stride on the last unit
of each block, so unit indices line up one-to-one.

Usage:
    python -m monopsr_torch.tools.convert_tf_resnet \
        --tf_checkpoint /path/to/model.ckpt --out_name resnet101_kitti

where ``model.ckpt`` is the checkpoint *prefix* (the directory contains
``model.ckpt.index`` and ``model.ckpt.data-00000-of-00001``).
"""

import argparse
import os
import re
import struct

import numpy as np

import monopsr_torch

# ---------------------------------------------------------------------------
# TF checkpoint V2 ("bundle") reader, from scratch.
#
# A checkpoint is <prefix>.index plus <prefix>.data-XXXXX-of-YYYYY shards.
# The .index file is a leveldb-format SSTable mapping tensor names to
# serialized BundleEntryProto messages (dtype/shape/shard/offset/size); the
# data shards are raw little-endian tensor bytes. Only the small subset of
# the formats a Saver-written checkpoint uses is implemented: uncompressed
# blocks, the proto fields BundleEntryProto actually populates, and fixed
# little-endian scalar types.
# ---------------------------------------------------------------------------

_SSTABLE_MAGIC = 0xdb4775248b80fb57
_FOOTER_SIZE = 48

_DTYPES = {
    1: np.dtype('<f4'),    # DT_FLOAT
    2: np.dtype('<f8'),    # DT_DOUBLE
    3: np.dtype('<i4'),    # DT_INT32
    4: np.dtype('<u1'),    # DT_UINT8
    5: np.dtype('<i2'),    # DT_INT16
    6: np.dtype('<i1'),    # DT_INT8
    9: np.dtype('<i8'),    # DT_INT64
    10: np.dtype('bool'),  # DT_BOOL
    19: np.dtype('<f2'),   # DT_HALF
}


def _read_varint(buf, pos):
    """Little-endian base-128 varint; returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7f) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _parse_block_entries(block):
    """Yields (key, value) pairs from one uncompressed SSTable block."""
    num_restarts = struct.unpack('<I', block[-4:])[0]
    data_end = len(block) - 4 - 4 * num_restarts
    pos = 0
    key = b''
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        value = block[pos:pos + value_len]
        pos += value_len
        yield key, value


def _read_block(data, handle):
    """Reads the block at a (offset, size) handle, checking compression."""
    offset, size = handle
    compression = data[offset + size]
    if compression != 0:
        raise ValueError(
            'Compressed SSTable block (type {}) not supported'.format(
                compression))
    return data[offset:offset + size]


def _read_handle(buf, pos):
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return (offset, size), pos


def read_index_entries(index_path):
    """Parses a bundle .index SSTable into {tensor_name: raw proto bytes}."""
    with open(index_path, 'rb') as f:
        data = f.read()

    footer = data[-_FOOTER_SIZE:]
    magic = struct.unpack('<Q', footer[-8:])[0]
    if magic != _SSTABLE_MAGIC:
        raise ValueError('{} is not an SSTable (bad magic)'.format(index_path))
    _, pos = _read_handle(footer, 0)          # metaindex handle (unused)
    index_handle, _ = _read_handle(footer, pos)

    entries = {}
    for _, handle_bytes in _parse_block_entries(
            _read_block(data, index_handle)):
        handle, _ = _read_handle(handle_bytes, 0)
        for key, value in _parse_block_entries(_read_block(data, handle)):
            entries[key.decode('utf-8')] = value
    return entries


def _parse_proto_fields(buf):
    """Decodes one protobuf message into {field_number: [raw values]}.

    Varint fields yield ints, length-delimited fields yield bytes,
    fixed32/64 yield ints. Enough for BundleEntryProto/TensorShapeProto.
    """
    fields = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value = struct.unpack('<Q', buf[pos:pos + 8])[0]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            value = struct.unpack('<I', buf[pos:pos + 4])[0]
            pos += 4
        else:
            raise ValueError('Unsupported wire type {}'.format(wire))
        fields.setdefault(field, []).append(value)
    return fields


def _parse_bundle_entry(raw):
    """BundleEntryProto: dtype=1, shape=2, shard_id=3, offset=4, size=5."""
    fields = _parse_proto_fields(raw)
    dtype = fields.get(1, [0])[0]
    shard_id = fields.get(3, [0])[0]
    offset = fields.get(4, [0])[0]
    size = fields.get(5, [0])[0]

    shape = []
    if 2 in fields:
        shape_fields = _parse_proto_fields(fields[2][0])
        for dim_raw in shape_fields.get(2, []):   # repeated Dim
            dim_fields = _parse_proto_fields(dim_raw)
            shape.append(dim_fields.get(1, [0])[0])
    return {'dtype': dtype, 'shape': tuple(shape),
            'shard_id': shard_id, 'offset': offset, 'size': size}


class BundleReader:
    """Reads tensors from a TF checkpoint V2 bundle without TensorFlow."""

    def __init__(self, prefix):
        self._prefix = prefix
        raw_entries = read_index_entries(prefix + '.index')
        # The empty key holds the BundleHeaderProto; everything else is a
        # tensor name -> BundleEntryProto.
        raw_entries.pop('', None)
        self._entries = {name: _parse_bundle_entry(raw)
                         for name, raw in raw_entries.items()}
        self._shards = {}

    def variable_names(self):
        return sorted(self._entries)

    def _shard_path(self, shard_id):
        num = len({e['shard_id'] for e in self._entries.values()})
        return '{}.data-{:05d}-of-{:05d}'.format(self._prefix, shard_id, num)

    def get_tensor(self, name):
        entry = self._entries[name]
        if entry['dtype'] not in _DTYPES:
            raise ValueError('Unsupported dtype {} for {}'.format(
                entry['dtype'], name))
        shard_id = entry['shard_id']
        if shard_id not in self._shards:
            with open(self._shard_path(shard_id), 'rb') as f:
                self._shards[shard_id] = f.read()
        raw = self._shards[shard_id][
            entry['offset']:entry['offset'] + entry['size']]
        array = np.frombuffer(raw, dtype=_DTYPES[entry['dtype']])
        return array.reshape(entry['shape']).copy()


# ---------------------------------------------------------------------------
# slim variable-name mapping
# ---------------------------------------------------------------------------

_BN_LEAF = {'gamma': 'scale', 'beta': 'bias',
            'moving_mean': 'mean', 'moving_variance': 'var'}

_RESNET_SCOPE_RE = re.compile(r'^(?:.*?/)?resnet_v1_\d+/')
_UNIT_RE = re.compile(
    r'^block(\d+)/unit_(\d+)/bottleneck_v1/(.+)$')


def map_slim_name(name):
    """Maps one slim checkpoint variable name to our NPZ key (or None).

    Handles both root-scoped names (``resnet_v1_101/conv1/weights``) and
    OD-API-scoped ones (``FirstStageFeatureExtractor/resnet_v1_101/...``).
    Returns None for variables outside the trunk (RPN heads, optimizer
    slots, block4/second-stage, global_step, ...).
    """
    m = _RESNET_SCOPE_RE.match(name)
    if not m:
        return None
    rest = name[m.end():]
    # Skip optimizer slot variables like .../weights/Momentum
    if rest.endswith(('/Momentum', '/Adam', '/Adam_1', '/RMSProp',
                      '/RMSProp_1', '/ExponentialMovingAverage')):
        return None

    if rest == 'conv1/weights':
        return 'conv1/kernel'
    m = re.match(r'^conv1/BatchNorm/(\w+)$', rest)
    if m and m.group(1) in _BN_LEAF:
        return 'conv1_bn/' + _BN_LEAF[m.group(1)]

    m = _UNIT_RE.match(rest)
    if not m:
        return None
    prefix = 'block{}_unit{}/'.format(m.group(1), m.group(2))
    tail = m.group(3)

    conv_m = re.match(r'^conv(\d)/weights$', tail)
    if conv_m:
        return prefix + 'conv{}/kernel'.format(conv_m.group(1))
    bn_m = re.match(r'^conv(\d)/BatchNorm/(\w+)$', tail)
    if bn_m and bn_m.group(2) in _BN_LEAF:
        return prefix + 'bn{}/{}'.format(bn_m.group(1), _BN_LEAF[bn_m.group(2)])
    if tail == 'shortcut/weights':
        return prefix + 'shortcut/kernel'
    sc_bn = re.match(r'^shortcut/BatchNorm/(\w+)$', tail)
    if sc_bn and sc_bn.group(1) in _BN_LEAF:
        return prefix + 'shortcut_bn/' + _BN_LEAF[sc_bn.group(1)]
    return None


def convert_checkpoint(prefix, max_block=3):
    """Reads a TF checkpoint and returns the mapped {npz_key: array} dict.

    Args:
        prefix: checkpoint path prefix (".index"/".data-*" alongside).
        max_block: highest ResNet block to keep (3 = the proposal-feature
            trunk the dual towers use; ref taps block3).
    """
    reader = BundleReader(prefix)
    out = {}
    for name in reader.variable_names():
        key = map_slim_name(name)
        if key is None:
            continue
        block_m = re.match(r'^block(\d+)_', key)
        if block_m and int(block_m.group(1)) > max_block:
            continue
        value = reader.get_tensor(name)
        if key in out and not np.array_equal(out[key], value):
            # First/Second-stage scopes can both map to the same trunk key;
            # keep the first (FirstStage) occurrence deterministically via
            # sorted order but flag genuine conflicts.
            raise ValueError('Conflicting values for {} (from {})'.format(
                key, name))
        out.setdefault(key, value)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--tf_checkpoint', required=True,
                        help='TF checkpoint prefix (e.g. .../model.ckpt)')
    parser.add_argument('--out_name', default='resnet101_kitti')
    parser.add_argument('--max_block', type=int, default=3)
    args = parser.parse_args(argv)

    converted = convert_checkpoint(args.tf_checkpoint, args.max_block)
    if not converted:
        raise SystemExit('No trunk variables found in {}'.format(
            args.tf_checkpoint))

    out_dir = os.path.join(monopsr_torch.data_dir(), 'pretrained')
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, args.out_name + '.npz')
    np.savez(out_path, **converted)
    print('Wrote {} arrays to {}'.format(len(converted), out_path))


if __name__ == '__main__':
    main()
