"""The traffic generators: the eval split's counts follow the stated
distribution, the seed permutes them and draws the content, and the
files it writes read back as the arrays it keeps; the train samples
repeat from their seed."""

import collections
import os

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference import kitti as ref_kitti
from benchmark.traffic import kitti_split, png, train_samples

VAL = harness.load_json(os.path.join(harness.BENCH_DIR, 'workloads',
                                     'eval_val.json'))


def test_counts_follow_the_stated_distribution():
    counts = kitti_split.frame_counts(VAL)
    params = VAL['objects_per_frame']
    objects = np.array([o for o, _ in counts])
    fps = np.array([f for _, f in counts])
    assert len(counts) == VAL['frames'] == 48
    crowded = int(round(params['crowded_share'] * VAL['frames']))
    lo, hi = params['crowded_range']
    assert ((objects >= lo) & (objects <= hi)).sum() >= crowded
    rest = np.sort(objects)[:-crowded]
    # Poisson(4): the mean of 46 draws lies within 4 +- 3 standard errors
    assert abs(rest.mean() - params['poisson_mean']) < 3 * np.sqrt(
        params['poisson_mean'] / len(rest))
    assert fps.min() >= 0 and fps.max() <= VAL['false_positives_max']
    # every slot bucket of the evaluator (8, 16, 32) is met
    assert objects.max() > 16 and ((objects > 8) & (objects <= 16)).any()
    assert (objects <= 8).sum() > 40


def test_a_pass_runs_through_the_frames_a_whole_number_of_times():
    assert kitti_split.pass_cycles(VAL) * VAL['frames'] == \
        VAL['frames_per_pass']
    assert kitti_split.pass_cycles(dict(VAL, frames_per_pass=None)) == 1
    with pytest.raises(ValueError):
        kitti_split.pass_cycles(dict(VAL, frames_per_pass=50))


def test_the_seed_permutes_the_same_counts(tmp_path):
    small = dict(VAL, frames=5, frames_per_pass=10, generator_threads=2,
                 objects_per_frame=dict(VAL['objects_per_frame'],
                                        crowded_share=0.2))
    first = kitti_split.make_split(small, 2 ** 33 + 1, str(tmp_path / 'a'))
    second = kitti_split.make_split(small, 7, str(tmp_path / 'b'))
    again = kitti_split.make_split(small, 2 ** 33 + 1, str(tmp_path / 'c'))

    def profile(split):
        return collections.Counter(
            (len(f.labels), len(f.detections)) for f in split.frames)
    assert profile(first) == profile(second)
    assert [f.labels for f in first.frames] == [f.labels for f in
                                               again.frames]
    # the same objects, in another order and another look
    assert sorted(f.labels for f in first.frames) == sorted(
        f.labels for f in second.frames)
    assert [f.labels for f in first.frames] != [f.labels for f in
                                               second.frames]
    assert not np.array_equal(first.frames[0].image,
                              second.frames[0].image)
    # the split list runs through the generated frames twice, in order
    with open(os.path.join(first.dataset_dir, 'val.txt')) as f:
        assert f.read().split() == first.names * 2
    assert first.cycles == 2
    for frame in first.frames:
        # every object is kept by the val filter; detections are the
        # objects plus at most three false positives
        assert len(ref_kitti.frame_labels(frame, 'val')[0]) == len(
            frame.labels)
        assert 0 <= len(frame.detections) - len(frame.labels) <= 3


@pytest.mark.parametrize('seed', [2 ** 33 + 3, 11])
def test_the_seed_keeps_the_dispatch_groups(seed):
    """Layouts are permuted in whole blocks of the evaluator's batch, so
    every seed dispatches the same groups of frames in another order."""
    layouts = kitti_split.frame_layouts(VAL)
    order = kitti_split._block_order(len(layouts), 4, seed)
    assert sorted(order) == list(range(len(layouts)))
    assert order != list(range(len(layouts)))

    def groups(indices):
        return sorted(tuple(sorted(indices[i:i + 4]))
                      for i in range(0, len(indices), 4))
    assert groups(order) == groups(list(range(len(layouts))))
    # a shorter last block keeps its place
    assert kitti_split._block_order(10, 4, seed)[8:] == [8, 9]


def test_written_files_read_back(tmp_path):
    """The port's PNG reader decodes what the generator wrote to the
    arrays the reference reads."""
    from monopsr_torch.utils import image_io
    split = kitti_split.make_split(dict(VAL, frames=2, generator_threads=1),
                                   99, str(tmp_path))
    root = os.path.join(split.dataset_dir, 'training')
    for frame in split.frames:
        for sub, array in (('image_2', frame.image),
                           ('depth_2_multiscale', frame.depth),
                           ('instance_2_depth_2_multiscale', frame.instance)):
            got = image_io.read_png(os.path.join(root, sub,
                                                 frame.name + '.png'))
            np.testing.assert_array_equal(got, array)
        size = os.path.getsize(os.path.join(root, 'image_2',
                                            frame.name + '.png'))
        assert 0.6e6 < size < 1.1e6       # near KITTI's ~0.85 MB


@pytest.mark.parametrize('shape,dtype', [((7, 5), np.uint8),
                                         ((6, 9, 3), np.uint8),
                                         ((4, 11), np.uint16)])
def test_png_round_trip(tmp_path, shape, dtype):
    from monopsr_torch.utils import image_io
    rng = np.random.RandomState(0)
    image = rng.randint(0, np.iinfo(dtype).max, shape).astype(dtype)
    path = str(tmp_path / 'x.png')
    png.write_png(path, image)
    np.testing.assert_array_equal(image_io.read_png(path), image)


def test_train_samples_repeat_from_their_seed():
    from benchmark.reference.monopsr_net import NetConfig
    cfg = NetConfig(resnet='resnet_tiny', image_input_shape=(96, 320),
                    num_boxes=4)
    params = {'distinct_samples': 3}
    a = train_samples.samples(params, 2 ** 33 + 5, cfg)
    b = train_samples.samples(params, 2 ** 33 + 5, cfg)
    c = train_samples.samples(params, 5, cfg)
    assert len(a) == 3
    for x, y in zip(a, b):
        for key in x:
            np.testing.assert_array_equal(x[key], y[key])
    assert not np.array_equal(a[0]['image'], c[0]['image'])
    assert not np.array_equal(a[0]['image'], a[1]['image'])
