#!/usr/bin/env python3
"""Times the EMD kernels K1 and K2 of one or more checkouts of the
PyTorch/CUDA port on one NVIDIA GPU, in turns, on the same clouds.

    python3 scripts/emd_kernels_ab.py --trees OLD NEW NEW OLD

Each tree is a checkout's root (holding ``monopsr_torch/`` and
``chip_smoke.py``); each run is a process of its own that builds that
tree's kernels and times them with that tree's ``chip_smoke.time_cuda``:
K1 at the eval step's (128, 2304, 2304) and K2 at the train step's
(32, 2304, 2304) on masked clouds (40% exact-zero points), and K1 on
32 masked pairs drawn apart against its plain version. One JSON line per
run; the card's name and power limit first.
"""

import argparse
import json
import os
import subprocess
import sys

REPS = 10


def one(tree):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from monopsr_torch.ops import cuda_build
    from monopsr_torch.ops import emd

    cuda_build.build()
    ptxas = [line.strip() for name in cuda_build.SOURCES
             for line in cuda_build.build_log(name).splitlines()
             if 'registers' in line or 'spill' in line]
    gen = torch.Generator(device='cuda').manual_seed(0)
    k1_clouds = cs.masked_clouds(gen, 128, 2304, 2304, 0.6)
    k2_clouds = cs.loss_clouds(gen, 32, 2304, 2304, 0.6)
    apart = cs.loss_clouds(gen, 32, 2304, 2304, 0.6, 2.5)
    k1_ms = cs.time_cuda(lambda: emd.emd_cost_fused(*k1_clouds), reps=REPS)
    k2_ms = cs.time_cuda(lambda: emd.emd_loss_accumulators(*k2_clouds),
                         reps=REPS)
    _, apart_rel = cs.rel_err(emd.emd_cost_fused(*apart),
                              emd.emd_cost_fused_plain(*apart))
    print(json.dumps({'tree': tree, 'k1_ms': k1_ms, 'k2_ms': k2_ms,
                      'k1_apart_max_rel_err': apart_rel, 'ptxas': ptxas}))


def run_in_turns(script, trees):
    """Runs ``script --one TREE`` for each tree in order, each in a process
    of its own, and writes the last line of its output (its JSON line);
    the card's name and power limit first. Stops at the first failing
    run and returns its exit code."""
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True).stdout.strip())
    for tree in trees:
        out = subprocess.run([sys.executable, os.path.abspath(script),
                              '--one', tree], capture_output=True,
                             text=True)
        if out.stdout:
            sys.stdout.write(out.stdout.splitlines()[-1] + '\n')
        if out.returncode != 0:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            return out.returncode
    return 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--trees', nargs='+', help='checkout roots, run '
                        'in this order')
    parser.add_argument('--one', help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        one(args.one)
        return 0
    return run_in_turns(__file__, args.trees)


if __name__ == '__main__':
    sys.exit(main())
