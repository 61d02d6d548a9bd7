"""The control of a cell's comparison, on the card:

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

For each seed, the plain reference is put in the program's place and
computed one precision step below the configuration's (float8 e4m3
operands for bfloat16 convolutions; TF32 for float32), on the cell's own
inputs at the cell's own size, and compared with the reference at the
configuration's precision by the same numbers as a run. One JSON line per
seed: the numbers, and whether the cell's limits call it correct (they
must not). The benchmark's own runs never run it.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

from benchmark import harness
from benchmark.drivers import common


def control_numbers(cell, seed, device, lower):
    """{number: value} of the reference computed at ``lower`` against the
    reference for ``seed`` (``lower`` None: two runs of the reference)."""
    cfg = common.ref_config(cell)
    kind = cell.traffic['kind']
    if kind == 'train':
        from benchmark.drivers import train
        batches = train._batches(cell, seed, cfg)
        batches = batches[:train.compared_steps(cell)]
        want, _ = train.reference_readings(cell, cfg, seed, batches, device)
        got, _ = train.reference_readings(cell, cfg, seed, batches, device,
                                          lower=lower)
        return train.compare(got, want)
    from benchmark.drivers import eval as eval_driver
    workdir = tempfile.mkdtemp(prefix='monopsr_control_')
    try:
        split = eval_driver.make_split(cell, seed,
                                       os.path.join(workdir, 'split'))
        want, _ = eval_driver.reference_outputs(cell, cfg, split, seed,
                                                device)
        got, _ = eval_driver.reference_outputs(cell, cfg, split, seed,
                                               device, lower=lower)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    got = dict(got, metrics=[got['metrics']], losses=[got['losses']])
    numbers, _ = eval_driver.compare(cell.traffic['mode'], got, want)
    return numbers


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    args = parser.parse_args(argv)
    harness.set_environment()
    cell = harness.Cell(args.workload)
    import torch
    device = torch.device('cuda')
    lower = common.lower_mode(cell)
    for seed in args.seeds:
        numbers = control_numbers(cell, seed, device, lower)
        checks = common.checks(cell, numbers)
        print(json.dumps({'workload': cell.name, 'seed': seed,
                          'lower': lower,
                          'numbers': numbers,
                          'correct': common.passed(checks)}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
