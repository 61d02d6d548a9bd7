"""Runs one cell of the port's benchmark once, on the card it starts on:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Set-up (the cell's inputs and weights from
the seed, the program built and warmed up on the cell's own shapes) is
timed as ``setup_s``; then the cell's driver runs the program for
``--seconds`` of wall time and checks what that window produced against
the plain reference. With ``--trace 0`` the last line of standard output
is one JSON object with the cell's end-to-end metrics; with ``--trace 1``
a traced stretch follows the window and the line holds the per-layer
metrics, the device's busy and window seconds and a breakdown. Every
number compared is printed beside its limit, last on standard error and
under ``compared`` in the line.

It exits non-zero and prints no result without a card (or with fewer
than the cell asks for), without the program in the checkout, or when
``jax``, ``jaxlib``, ``flax`` or ``monopsr_tpu`` is loaded once the
window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error('--seed must be a non-negative integer')
    try:
        harness.set_environment()
        cell = harness.Cell(args.workload)
        torch = harness.require_cards(cell.chips)
        try:
            import monopsr_torch  # noqa: F401
        except ImportError as exc:
            raise harness.Refused('the program is not in this checkout: '
                                  '{}'.format(exc)) from None
        run = harness.driver(cell.traffic['kind']).run(
            cell, args.seed, args.seconds, bool(args.trace), T0)
        loaded = harness.forbidden_modules()
        if loaded:
            raise harness.Refused('forbidden modules loaded: {}'.format(
                ', '.join(loaded)))
    except harness.Refused as exc:
        print('benchmark: ' + str(exc), file=sys.stderr)
        return 2

    section = 'per_layer' if args.trace else 'end_to_end'
    metrics = {}
    for entry in cell.metrics(section):
        value = harness.load_reader(entry['name'])(run.context)
        if value is not None:
            metrics[entry['name']] = {'value': value, 'unit': entry['unit']}
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': cell.chips,
              'memory_peak_bytes': run.context['memory_peak_bytes']}
    breakdown = None
    trace = run.context.get('trace')
    if args.trace and trace is not None:
        device['busy_s'] = trace['busy_s']
        device['window_s'] = trace['window_s']
        breakdown = {'device_ops': trace['device_ops'],
                     'idle_gaps': trace['idle_gaps']}
    for name, value, limit in run.checks:
        print('compared {}: {!r} (limit {!r})'.format(name, value, limit),
              file=sys.stderr)
    print(json.dumps(harness.result_line(
        run.correct, run.attempted, run.failed, metrics, device, run.checks,
        breakdown)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
