#!/usr/bin/env python3
"""Which calls a CUDA graph capture of the train step takes, on the card.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/graph_capture_probe.py

Each case runs in a subprocess of its own (a refused call can leave the
capture, and the process's CUDA state, unusable) and prints one line:
``legal`` or ``refused`` with the error. The cases are the questions the
graphed train step (``monopsr_torch/train/step_graph.py``) had to answer:

- ``cluster_query``: K2's cluster-size query (``cudaFuncSetAttribute``
  and ``cudaOccupancyMaxActiveClusters`` with a launch configuration on
  stream 0) inside a capture;
- ``k2_launch``: a whole K2 launch inside a capture (the query, then
  ``cudaLaunchKernelEx``); the replay's accumulators against an eager
  launch's, bit for bit;
- ``rng_state``: ``torch.cuda.get_rng_state()`` inside a capture, which
  ``torch.utils.checkpoint`` reads with ``preserve_rng_state=True``;
- ``checkpoint_preserving_rng``: a checkpointed unit's forward and
  backward inside a capture with ``preserve_rng_state=True`` (the
  default), and ``checkpoint_without_rng`` with it off; both after one
  eager run on the capture's stream, as the graphed step warms up.
"""

import argparse
import ctypes
import os
import subprocess
import sys

CASES = ('cluster_query', 'k2_launch', 'rng_state',
         'checkpoint_preserving_rng', 'checkpoint_without_rng')


def run_case(name):
    import torch
    from torch.utils import checkpoint

    from monopsr_torch.ops import cuda_build, emd

    b, n, m = 32, 2304, 2304
    gen = torch.Generator(device='cuda').manual_seed(0)
    xyz1 = torch.randn(b, n, 3, generator=gen, device='cuda')
    xyz2 = torch.randn(b, m, 3, generator=gen, device='cuda')
    graph = torch.cuda.CUDAGraph()
    if name == 'cluster_query':
        lib = cuda_build.load('emd_loss')
        lib.emd_loss_cluster_size.argtypes = [ctypes.c_int] * 3
        with torch.cuda.graph(graph):
            size = lib.emd_loss_cluster_size(b, n, m)
        return 'cluster size {} (negative: a cudaError_t)'.format(size)
    if name == 'k2_launch':
        want = emd.emd_loss_accumulators(xyz1, xyz2)
        with torch.cuda.graph(graph):
            got = emd.emd_loss_accumulators(xyz1, xyz2)
        graph.replay()
        torch.cuda.synchronize()
        return 'replay bit for bit equal to an eager launch: {}'.format(
            all(torch.equal(g, w) for g, w in zip(got, want)))
    if name == 'rng_state':
        with torch.cuda.graph(graph):
            torch.cuda.get_rng_state()
        return 'read'
    weight = torch.randn(16, 16, device='cuda', requires_grad=True)
    x = torch.randn(8, 16, device='cuda', requires_grad=True)

    def unit(v):
        return torch.relu(v @ weight)

    def step():
        y = checkpoint.checkpoint(
            unit, x, use_reentrant=False,
            preserve_rng_state=name == 'checkpoint_preserving_rng')
        y.sum().backward()

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step()
    torch.cuda.current_stream().wait_stream(stream)
    x.grad = weight.grad = None
    with torch.cuda.graph(graph, stream=stream):
        step()
    graph.replay()
    torch.cuda.synchronize()
    return 'forward and backward captured and replayed'


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--case', choices=CASES,
                        help='run one case in this process')
    args = parser.parse_args()
    if args.case:
        print(run_case(args.case))
        return 0
    top = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in CASES:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--case', name],
            cwd=top, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=top))
        if proc.returncode == 0:
            print('{}: legal ({})'.format(name, proc.stdout.strip()))
        else:
            error = [line for line in proc.stderr.splitlines()
                     if 'Error' in line]
            print('{}: refused ({})'.format(
                name, (error or proc.stderr.splitlines() or ['?'])[-1]))
    return 0


if __name__ == '__main__':
    sys.exit(main())
