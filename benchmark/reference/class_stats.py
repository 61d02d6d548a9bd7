"""Per-class statistical constants used by the network and its inputs.

Own copy of ``monopsr_tpu/geometry/class_stats.py``: the image channel
means, the regression trunk's cen_y normalizer and the per-class mean
tables of ``geometry.feature_normalization``; the per-class mean and std
lwh, mean heights, proposal offsets and cen_y trend offsets that build a
sample's inputs; the KITTI difficulty thresholds and the MSCNN merge
IoU of the dataset layer.
"""

CLASSES = ('Car', 'Pedestrian', 'Cyclist')

MEAN_LWH = {
    'Car': [3.892, 1.619, 1.530],
    'Pedestrian': [0.818, 0.628, 1.768],
    'Cyclist': [1.771, 0.570, 1.723],
}

STD_LWH = {
    'Car': [0.440, 0.106, 0.138],
    'Pedestrian': [0.245, 0.122, 0.130],
    'Cyclist': [0.153, 0.143, 0.104],
}

MEAN_HEIGHTS = {
    'Car': 1.526,
    'Pedestrian': 1.761,
    'Cyclist': 1.737,
}

# Proposal z-centroid offsets added to the pinhole depth estimate
PROP_CEN_Z_OFFSET = {
    'Car': 2.17799973487854,
    'Pedestrian': 0.351921409368515,
    'Cyclist': 0.8944902420043945,
}

# cen_y trend offsets (subtracted from the box-centre projection estimate),
# keyed by (class, trend_data) for centroid_type 'middle'
CEN_Y_TREND_OFFSET_MIDDLE = {
    ('Car', 'kitti'): 0.0648,
    ('Car', 'mscnn'): 0.0655,
    ('Pedestrian', 'kitti'): 0.0145,
    ('Pedestrian', 'mscnn'): 0.0142,
    ('Cyclist', 'kitti'): 0.0239,
    ('Cyclist', 'mscnn'): 0.0239,
}

# centroid_type 'bottom' (uses mean height / 2 then subtracts offset)
CEN_Y_TREND_OFFSET_BOTTOM = {
    ('Car', 'kitti'): 0.0641,
    ('Car', 'mscnn'): 0.0637,
}

# Image channel means (RGB)
KITTI_CHANNEL_MEANS = (92.8403, 97.7996, 93.5843)
IMAGENET_CHANNEL_MEANS = (123.68, 116.78, 103.94)

# Normalization means (feature_normalization)
MEAN_CEN_Y = {'Car': 1.7153475, 'Pedestrian': 1.4557862,
              'Cyclist': 1.5591882}
MEAN_CEN_Z = {'Car': 25.24178, 'Pedestrian': 17.95974,
              'Cyclist': 21.279533}
MEAN_BOX_2D_H = {'Car': 61.594734, 'Pedestrian': 95.95055,
                 'Cyclist': 76.85717}

# cen_y proposal normalizer used by the regression FC trunk
PROP_CEN_Y_NORM = 1.666754

# KITTI difficulty thresholds (easy, moderate, hard)
DIFFICULTY_HEIGHT = (40, 25, 25)
DIFFICULTY_OCCLUSION = (0, 1, 2)
DIFFICULTY_TRUNCATION = (0.15, 0.3, 0.5)

# MSCNN<->KITTI merge IoU per class name
MSCNN_MERGE_MIN_IOU = {'Car': 0.7, 'Pedestrian': 0.5, 'Cyclist': 0.5}
