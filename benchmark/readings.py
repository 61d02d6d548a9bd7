"""The numbers a cell compares, over several seeds in one process, on the
card:

    python3 -m benchmark.readings --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds <s>] [--fault <name>]

Each seed runs the cell's driver as a run does (set-up, a window of
``--seconds``, the comparison with the plain reference) and prints one
JSON line: every number the driver works out, the limits of those the
cell compares, and whether the cell's limits call the run correct. The
lower reading of a limit
(``benchmark/limits/<cell>.json``) is the largest that sound runs give
over a dozen seeds or more. With ``--fault``, the timed path is broken
underneath first (``FAULTS``), and the limits have to call every seed
not correct. The benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time

from benchmark import harness


def _first_batch_replayed():
    """Train: every dispatch takes all its steps on its first batch."""
    from benchmark.drivers import train
    real = train._Program.dispatch
    train._Program.dispatch = lambda self, batches: real(
        self, [batches[0]] * len(batches))


FAULTS = {'first_batch_replayed': _first_batch_replayed}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    parser.add_argument('--seconds', type=float, default=1.0)
    parser.add_argument('--fault', choices=sorted(FAULTS))
    args = parser.parse_args(argv)
    harness.set_environment()
    cell = harness.Cell(args.workload)
    harness.require_cards(cell.chips)
    if args.fault:
        FAULTS[args.fault]()
    driver = harness.driver(cell.traffic['kind'])
    for seed in args.seeds:
        run = driver.run(cell, seed, args.seconds, False, time.perf_counter())
        print(json.dumps({
            'workload': cell.name, 'seed': seed, 'fault': args.fault,
            'numbers': run.context['numbers'],
            'limits': {name: limit for name, _, limit in run.checks},
            'correct': bool(run.correct)}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
