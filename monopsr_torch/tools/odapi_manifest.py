"""Expected variable manifest of the TF OD-API ResNet zoo checkpoint.

Own copy of ``monopsr_tpu/tools/odapi_manifest.py`` on the port's
``RESNET_SPECS``: the same names, shapes and order.

The reference initializes both feature towers from the zoo checkpoint
``faster_rcnn_resnet101_kitti_2018_01_28`` by rewriting the model's
dual tower scopes onto the checkpoint's single first-stage scope
(ref: src/monopsr/core/checkpoint_utils.py:64-117 — the
``FirstStageFeatureExtractor_{full,crop}/`` -> ``FirstStageFeatureExtractor/``
replace; restore scopes listed at
src/monopsr/core/models/monopsr/monopsr_model.py:1258-1263).

This module encodes, from the slim resnet_v1 structure
(ref: src/object_detection/nets/resnet_v1.py:310-334, resnet_utils.py),
the EXACT set of trunk variable names and shapes that checkpoint
carries for the proposal-feature extractor (conv1 + blocks 1..3 —
block4 lives under ``SecondStageFeatureExtractor/``). It is the ground
truth the converter's name map is tested against
(tests/test_torch_converters.py): any drift between
``convert_tf_resnet.map_slim_name`` and this documented layout fails
the 1:1 coverage/shape assertions.
"""

import collections

from monopsr_torch.models.resnet import RESNET_SPECS

FIRST_STAGE_SCOPE = 'FirstStageFeatureExtractor'
SECOND_STAGE_SCOPE = 'SecondStageFeatureExtractor'

# The model graph's dual-tower scopes, rewritten onto the checkpoint's
# single first-stage scope by the reference's restore remap
# (checkpoint_utils.py:88-92).
MODEL_TOWER_SCOPES = ('FirstStageFeatureExtractor_full',
                      'FirstStageFeatureExtractor_crop')

_BN_LEAVES = ('gamma', 'beta', 'moving_mean', 'moving_variance')


def _add_bn(manifest, scope, features):
    for leaf in _BN_LEAVES:
        manifest['{}/BatchNorm/{}'.format(scope, leaf)] = (features,)


def trunk_manifest(depth=101, scope=FIRST_STAGE_SCOPE, num_blocks=3):
    """{zoo variable name: shape} for the first-stage ResNet trunk.

    Args:
        depth: ResNet depth (50/101/152), selecting the unit counts.
        scope: outer checkpoint scope (FirstStageFeatureExtractor for
            the zoo layout; pass a MODEL_TOWER_SCOPES entry to produce
            the model-graph names instead).
        num_blocks: blocks under this scope (the OD-API first stage
            runs conv1 + blocks 1..3).

    Returns:
        OrderedDict mapping e.g.
        'FirstStageFeatureExtractor/resnet_v1_101/block3/unit_23/
         bottleneck_v1/conv2/weights' -> (3, 3, 256, 256).
    """
    spec = RESNET_SPECS['resnet{}'.format(depth)]
    root = '{}/resnet_v1_{}/'.format(scope, depth)
    manifest = collections.OrderedDict()

    manifest[root + 'conv1/weights'] = (7, 7, 3, 64)
    _add_bn(manifest, root + 'conv1', 64)

    in_ch = 64
    for block_idx, (num_units, depth_bottleneck) in enumerate(
            spec[:num_blocks]):
        out_ch = depth_bottleneck * 4
        for unit_idx in range(num_units):
            unit = '{}block{}/unit_{}/bottleneck_v1/'.format(
                root, block_idx + 1, unit_idx + 1)
            if unit_idx == 0:
                # Projection shortcut on the first unit of each block
                # (slim bottleneck_v1: depth change => 1x1 projection)
                manifest[unit + 'shortcut/weights'] = (1, 1, in_ch, out_ch)
                _add_bn(manifest, unit + 'shortcut', out_ch)
            manifest[unit + 'conv1/weights'] = (1, 1, in_ch, depth_bottleneck)
            _add_bn(manifest, unit + 'conv1', depth_bottleneck)
            manifest[unit + 'conv2/weights'] = (
                3, 3, depth_bottleneck, depth_bottleneck)
            _add_bn(manifest, unit + 'conv2', depth_bottleneck)
            manifest[unit + 'conv3/weights'] = (
                1, 1, depth_bottleneck, out_ch)
            _add_bn(manifest, unit + 'conv3', out_ch)
            in_ch = out_ch
    return manifest


def rewrite_model_scope_to_checkpoint(name):
    """The reference's dual-scope restore rewrite, one name at a time.

    ``FirstStageFeatureExtractor_{full,crop}/...`` ->
    ``FirstStageFeatureExtractor/...`` (checkpoint_utils.py:88-92);
    names outside the tower scopes pass through unchanged, matching
    str.replace semantics there.
    """
    for tower_scope in MODEL_TOWER_SCOPES:
        name = name.replace(tower_scope + '/', FIRST_STAGE_SCOPE + '/')
    return name


def distractor_names(depth=101):
    """Representative NON-trunk variables of the real zoo checkpoint.

    The converter must map every one of these to None (or drop it via
    max_block): RPN/box-predictor heads, the second-stage block4,
    optimizer slots, global_step. Names follow the OD-API Faster-RCNN
    graph the zoo checkpoint was written from.
    """
    root2 = '{}/resnet_v1_{}/'.format(SECOND_STAGE_SCOPE, depth)
    names = [
        'global_step',
        # RPN first-stage box predictor
        'Conv/weights',
        'Conv/biases',
        'FirstStageBoxPredictor/BoxEncodingPredictor/weights',
        'FirstStageBoxPredictor/BoxEncodingPredictor/biases',
        'FirstStageBoxPredictor/ClassPredictor/weights',
        'FirstStageBoxPredictor/ClassPredictor/biases',
        # Second-stage box predictor
        'SecondStageBoxPredictor/BoxEncodingPredictor/weights',
        'SecondStageBoxPredictor/ClassPredictor/weights',
        # Optimizer slot variables alongside trunk weights
        ('FirstStageFeatureExtractor/resnet_v1_{}/conv1/weights/Momentum'
         .format(depth)),
        ('FirstStageFeatureExtractor/resnet_v1_{}/block1/unit_1/'
         'bottleneck_v1/conv1/weights/RMSProp'.format(depth)),
    ]
    # block4 = second stage; excluded from the trunk by max_block=3
    names += [
        root2 + 'block4/unit_1/bottleneck_v1/conv1/weights',
        root2 + 'block4/unit_1/bottleneck_v1/conv1/BatchNorm/gamma',
        root2 + 'block4/unit_1/bottleneck_v1/shortcut/weights',
    ]
    return names
