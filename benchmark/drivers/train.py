"""The train cells' driver: the port's graphed train step as
``trainer.train`` runs it at ``steps_per_dispatch`` K.

Set-up builds one train step and state (``trainer.make_train_step`` with
the config's loss, clip 1.0, Adam under the exponential decay, the EMA)
over weights made from the seed (``benchmark/weights.py``) and wraps it
in ``train/step_graph.GraphedTrainStep``. It then takes the run's first
1 + K steps through that object's own call, as the window takes them:
one dispatch of one batch (the eager warm-up step), then one dispatch of
K batches (the capture and K - 1 replays, each step reading its own row
of the dispatch's upload), on 1 + K different samples, reading each
step's loss after its replay. The window sends dispatches of K batches,
cycling through the mix's distinct samples, until ``seconds`` have
passed, and waits for the card. ``train_samples_per_s`` is the samples
of every step completed over the window's wall time. K and the batch
are the mix's ``train_config``, merged into the program's config, as
the program reads them.

Correctness: once the window has closed and the program is freed, the
plain reference (``reference/train.py``) takes the same 1 + K steps from
the same weights on the same samples. The driver works out, each side
against the reference: ``loss_gap.s<i>`` (step i's total loss,
relative), ``grad_gap`` (the first step's clipped gradient, read from
Adam's first moment after one step, by the worst leaf), ``change_gap``
(the parameters' change after the 1 + K steps, by the worst leaf) and
``ema_gap`` (the EMA's change after them, by the median leaf: it moves
by 1e-4 of the parameters' change a step, near float32's resolution, so
its worst leaf reads rounding). A leaf's gap is the gap between the two
sides' norms of that leaf, over the larger of the reference's norm of
that leaf and of the median leaf; leaves whose reference gradient is
under a thousandth of the median leaf's are left out of the change
(Adam moves them by round-off alone). The cell's limits
(``benchmark/limits/<cell>.json``) name the numbers it compares: of the
losses, the steps that stay steady from seed to seed, since a
random-weight net under Adam grows a rounding gap about tenfold a step.
"""

import math
import sys
import shutil
import tempfile
import time

import numpy as np

from benchmark import harness
from benchmark.drivers import common
from benchmark.reference import train as ref_train
from benchmark.traffic import train_samples


def _stack(samples):
    return {key: np.stack([s[key] for s in samples]) for key in samples[0]}


def settings(cell):
    """The cell's train settings: its configuration's ``train_config``
    with the mix's ``train_config`` over it (what the program reads)."""
    return dict(cell.experiment['train_config'],
                **cell.traffic.get('train_config', {}))


def compared_steps(cell):
    """The steps the comparison follows: the first dispatch's one and one
    dispatch of K."""
    return 1 + max(1, int(settings(cell).get('steps_per_dispatch', 1)))


def _batches(cell, seed, cfg):
    batch = int(settings(cell)['batch_size'])
    samples = train_samples.samples(cell.traffic, seed, cfg)
    return [_stack(samples[i:i + batch])
            for i in range(0, len(samples) - batch + 1, batch)]


def _norms(tensors):
    """Per-tensor L2 norms, in float64 on the host."""
    import torch
    return [float(x) for x in torch.stack(torch._foreach_norm(
        [t.detach().float() for t in tensors])).double().cpu()]


def _readings(names, losses, grad_norms, params, ema, start):
    """The numbers one side gives: each step's total loss, and per leaf
    the norms of the first clipped gradient (``grad_norms``) and of the
    parameters' and EMA's change since ``start``."""
    import torch
    start = [start[n] for n in names]
    return {
        'names': names,
        'losses': losses,
        'grad': grad_norms,
        'change': _norms(torch._foreach_sub([params[n] for n in names],
                                            start)),
        'ema': _norms(torch._foreach_sub([ema[n] for n in names], start)),
    }


def _leaf_gaps(got, want, keep=None):
    """Per leaf kept: the gap between the two sides' norms over the
    larger of the reference's norm of that leaf and of the median leaf."""
    want = np.asarray(want)
    got = np.asarray(got)
    keep = np.ones(len(want), bool) if keep is None else keep
    floor = max(float(np.median(want[keep])), 1e-30)
    return (np.abs(got - want) / np.maximum(want, floor))[keep]


def compare(got, want):
    """{number: value} of one side's readings against the reference's."""
    grad = np.asarray(want['grad'])
    keep = grad >= 1e-3 * np.median(grad)
    numbers = {
        'grad_gap': float(_leaf_gaps(got['grad'], want['grad']).max()),
        'change_gap': float(_leaf_gaps(got['change'], want['change'],
                                       keep).max()),
        # the median leaf: each step moves the EMA by 1e-4 of the
        # parameters' change, near float32's resolution of the
        # parameters, so its worst leaf reads rounding
        'ema_gap': float(np.median(_leaf_gaps(got['ema'], want['ema'],
                                              keep))),
    }
    for i, (g, w) in enumerate(zip(got['losses'], want['losses'])):
        numbers['loss_gap.s{}'.format(i + 1)] = abs(g - w) / max(
            abs(w), 1e-30) if math.isfinite(g) else float('inf')
    return numbers


def reference_readings(cell, cfg, seed, batches, device, lower=None,
                       count_flops=False):
    """The plain reference's readings over the first len(batches) steps,
    from the seed's weights; with ``lower``, computed one precision step
    below the configuration's ('fp8' for bfloat16 convolutions, 'tf32'
    for float32): the control. Returns (readings, FLOPs per step)."""
    import torch
    net, state = common.reference_net(cfg, seed, device)
    common.lower_precision(net, lower)
    opt = cell.experiment['train_config']['optimizer']
    adam = ref_train.Adam(opt[opt['optimizer_type']], common.ema_decay(cell))
    flops = None
    with common.tf32(lower == 'tf32'):
        if count_flops:
            from torch.utils.flop_counter import FlopCounterMode
            counter = FlopCounterMode(display=False)
            with counter:
                out = ref_train.run_steps(net, cfg, common.loss_config(cell),
                                          adam, batches, device)
            flops = counter.get_total_flops() / len(batches)
        else:
            out = ref_train.run_steps(net, cfg, common.loss_config(cell),
                                      adam, batches, device)
    losses, grads, params, ema = out
    names = [n for n, _ in net.named_parameters()]
    readings = _readings(names, losses, _norms([grads[n] for n in names]),
                         params, ema, state)
    del net, state, out, grads, params, ema, adam
    common.free(device)
    return readings, flops


class _Program:
    """The port's graphed train step over the seed's weights."""

    def __init__(self, cell, config, seed, device, spans):
        from monopsr_torch.models import monopsr
        from monopsr_torch.models.monopsr_net import NetConfig
        from monopsr_torch.train import optimizer as opt_lib
        from monopsr_torch.train import step_graph, trainer
        self.cfg = NetConfig.from_model_config(config.model_config,
                                               config.dataset_config)
        net = monopsr.create_net(self.cfg, device=device, seed=0)
        net.load_state_dict(common.make_weights(
            common.ref_config(cell), seed, device))
        tx, _, use_ema, decay = opt_lib.build_optimizer(
            config.train_config.to_dict(), clip_gradient_norm=1.0)
        self.step = trainer.make_train_step(
            net, self.cfg, config.model_config.loss_config.to_dict(), tx,
            use_ema, decay, device=device)
        self.state = trainer.create_train_state(net, tx, use_ema)
        self.net = net
        self.k = trainer.steps_per_dispatch(config.train_config)
        self.batch = int(config.train_config.get('batch_size'))
        self.read = None
        self.cuda = device.type == 'cuda'
        if self.cuda:
            self.graphed = step_graph.GraphedTrainStep(self.step, device)
        else:
            # the CPU tests' stand-in: the loop's eager dispatch
            self.graphed = trainer.eager_steps(self._cpu_step)
        if spans.enabled and self.cuda:
            self.graphed._upload = spans.wrap(self.graphed._upload, 'upload')
            self.graphed.replay = spans.wrap(self.graphed.replay, 'replay')

    def _cpu_step(self, state, batch):
        state, losses = self.step(state, batch)
        if self.read is not None:
            self.read.append(losses['total_loss'].detach().clone())
        return state, losses

    def dispatch(self, batches):
        self.state, losses = self.graphed(self.state, batches)
        return losses

    def dispatch_reading(self, batches):
        """One dispatch of ``batches``; returns each step's total loss,
        read from the graph's loss tensor after that step's replay (the
        copy is queued on the replay's stream: no host wait between
        replays)."""
        self.read = []
        graphed = self.graphed
        if self.cuda:
            replay = graphed.replay

            def replay_and_read():
                replay()
                self.read.append(
                    graphed.losses['total_loss'].detach().clone())
            graphed.replay = replay_and_read
        try:
            out = self.dispatch(batches)
        finally:
            if self.cuda:
                graphed.replay = replay
            read, self.read = self.read, None
        if len(read) < len(batches):
            # the run's first step runs eagerly, with no replay
            if len(batches) != 1:
                raise ValueError('read the losses of a first dispatch of '
                                 'one batch')
            read = [out['total_loss']]
        return [float(x) for x in read]


def run(cell, seed, seconds, tracing, t0, device='cuda'):
    import torch
    from monopsr_torch.utils import device as device_lib
    device = device_lib.resolve_device(device)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    spans = harness.Spans(tracing)
    workdir = tempfile.mkdtemp(prefix='monopsr_bench_')
    try:
        config = common.program_config(cell, seed, workdir)
        cfg = common.ref_config(cell)
        batches = _batches(cell, seed, cfg)
        prog = _Program(cell, config, seed, device, spans)
        k, batch = prog.k, prog.batch

        # The first 1 + K steps, as the window takes them: the run's first
        # dispatch (one batch, the eager warm-up step), then one of K
        # (the capture, then K - 1 replays from the upload's later rows)
        first = 1 + k
        losses = prog.dispatch_reading(batches[:1])
        # Adam's first moment after one step is 0.1 x the clipped gradient
        names = list(prog.state.params)
        mu = prog.state.opt_state['mu']
        grad_norms = [x / 0.1 for x in _norms([mu[n] for n in names])]
        losses += prog.dispatch_reading(batches[1:first])
        start = common.make_weights(cfg, seed, device)
        program = _readings(names, losses, grad_norms, prog.state.params,
                            prog.state.ema_params, start)
        del start
        common.synchronize(device)
        setup_s = time.perf_counter() - t0

        cursor, steps = first, 0
        t_start = time.perf_counter()
        while True:
            group = [batches[(cursor + j) % len(batches)] for j in range(k)]
            cursor += k
            with spans('dispatch'):
                window_losses = prog.dispatch(group)
            steps += k
            if time.perf_counter() - t_start >= seconds:
                break
        with spans('wait'):
            common.synchronize(device)
        window_s = time.perf_counter() - t_start
        last_loss = float(window_losses['total_loss'])
        peak = common.memory_peak(device)

        trace = None
        if tracing:
            def traced_dispatches():
                nonlocal cursor
                for _ in range(int(cell.traffic['traced_dispatches'])):
                    group = [batches[(cursor + j) % len(batches)]
                             for j in range(k)]
                    cursor += k
                    with spans('dispatch'):
                        prog.dispatch(group)
            _, trace = harness.traced(traced_dispatches, spans)
        del prog
        common.free(device)

        want, flops = reference_readings(cell, cfg, seed, batches[:first],
                                         device, count_flops=True)
        numbers = compare(program, want)
        print('losses of the first steps: program {}, reference {}'.format(
            program['losses'], want['losses']), file=sys.stderr)
        grad = np.asarray(want['grad'])
        kept = np.flatnonzero(grad >= 1e-3 * np.median(grad))
        for key, leaves in (('grad', np.arange(len(grad))), ('change', kept)):
            gaps = _leaf_gaps(program[key], want[key], np.isin(
                np.arange(len(grad)), leaves))
            worst = int(leaves[int(np.argmax(gaps))])
            print('worst {} leaf: {} ({!r}; norms {!r} against {!r})'.format(
                key, want['names'][worst], float(gaps.max()),
                program[key][worst], want[key][worst]), file=sys.stderr)
        checks = common.checks(cell, numbers)
        context = dict(
            kind='train', setup_s=setup_s, window_s=window_s,
            units=steps * batch, steps=steps,
            memory_peak_bytes=peak, flops_per_step=flops,
            compute_dtype=cell.experiment['model_config']['compute_dtype'],
            trace=trace, numbers=numbers)
        failed = 0 if math.isfinite(last_loss) else 1
        correct = failed == 0 and common.passed(checks)
        return common.Run(context, checks, steps * batch, failed * steps,
                          correct)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
