#!/usr/bin/env python3
"""Plants known faults in copies of the EMD sweep (csrc/emd_sweep.cuh)
and checks that chip_smoke.py's kernel phases catch each one, on one
NVIDIA GPU:

    python3 scripts/emd_planted_faults.py [--workdir DIR]

For each fault, the port (``monopsr_torch/``) and ``chip_smoke.py`` are
copied into DIR/<fault>/ (default: build/planted_faults/, listed in
.gitignore), the fault is written into the copy's header (which the
build hashes, so the copy builds its own library), and the phases run
there in a process of their own. Every phase must exit 1 (a check
failed); the line of the check that failed is printed. Exits 1 unless
every fault is caught.
"""

import argparse
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join('monopsr_torch', 'csrc', 'emd_sweep.cuh')

# name -> (text in the header, its replacement, phases that must fail)
FAULTS = {
    'no_final_row_sweep': (
        '''    row_pass<kGrad, kFinalSweep>(s, g, team, 0.0f, 0.0f, row_lo,
                                 row_hi, n, m);''',
        '',
        ('kernel_phase_k2',)),
    'final_sweep_without_grow': (
        '''        g.grow[i] = __fadd_rn(g.grow[i], __fmul_rn(r_scale, tg));''',
        '''        if (kMode != kFinalSweep) {
          g.grow[i] = __fadd_rn(g.grow[i], __fmul_rn(r_scale, tg));
        }''',
        ('kernel_phase_k2',)),
    'last_column_skipped': (
        '''    if (j[k] >= col_hi) continue;''',
        '''    if (j[k] >= col_hi || j[k] == m - 1) continue;''',
        ('kernel_phase', 'kernel_phase_k2')),
    'rank0_row_scale_not_shared': (
        '''        store_all(team, s.rs + i, __fdiv_rn(sl, __fadd_rn(row_sum, 1e-9f)));''',
        '''        const float scale = __fdiv_rn(sl, __fadd_rn(row_sum, 1e-9f));
        if (team.rank == 0) {
          s.rs[i] = scale;
        } else {
          store_all(team, s.rs + i, scale);
        }''',
        ('kernel_phase', 'kernel_phase_k2')),
}


def plant(workdir, name):
    old, new, _ = FAULTS[name]
    copy = os.path.join(workdir, name)
    shutil.rmtree(copy, ignore_errors=True)
    os.makedirs(copy)
    shutil.copytree(os.path.join(REPO, 'monopsr_torch'),
                    os.path.join(copy, 'monopsr_torch'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), copy)
    path = os.path.join(copy, HEADER)
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit('fault {}: the text to replace is not in {} once'
                         .format(name, HEADER))
    with open(path, 'w') as f:
        f.write(text.replace(old, new))
    return copy


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workdir', default=os.path.join(
        REPO, 'build', 'planted_faults'))
    args = parser.parse_args()
    caught = True
    for name, (_, _, phases) in FAULTS.items():
        copy = plant(args.workdir, name)
        for phase in phases:
            out = subprocess.run(
                [sys.executable, '-c',
                 'import chip_smoke; chip_smoke.{}(0)'.format(phase)],
                cwd=copy, capture_output=True, text=True)
            lines = (out.stdout + out.stderr).splitlines()
            failed = [l for l in lines if 'FAILED' in l]
            # The last measurement line before the failure holds the numbers
            numbers = [l for l in lines if l.startswith('kernel ')]
            print('fault {} phase {}: exit {}'.format(name, phase,
                                                      out.returncode))
            for line in numbers[-1:] + failed:
                print('  ' + line[:900])
            if out.returncode != 1 or not failed:
                caught = False
                print('  NOT CAUGHT' + (': ' + out.stderr[-2000:]
                                        if out.returncode else ''))
    print('all faults caught' if caught else 'a fault was not caught')
    return 0 if caught else 1


if __name__ == '__main__':
    sys.exit(main())
