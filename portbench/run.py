"""Run one cell of the benchmark once on the card:

    python -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed from the process's start) builds the kernels, the cell's
inputs and weights from the seed, the program's state, and runs the
warm-up; then the window measures for ``--seconds``; then the reference
checks what the timed path produced.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and ``checks``); every
other line goes to standard error, the compared numbers and their limits
last.  No card, too few cards, or a JAX module loaded: no result and a
non-zero exit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache inside the checkout, at fixed paths
CACHE = os.path.join(ROOT, '.portbench_cache')
os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHE, 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHE, 'torch_extensions')
os.environ['USE_FLAX'] = '0'

from portbench import guard, harness, spec  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f'not read ({e})'
    return out[0] if out else 'not read'


def main(argv=None) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    t = time.perf_counter()
    import torch
    import softgroup_tpu_torch  # noqa: F401
    import_s = time.perf_counter() - t
    if not torch.cuda.is_available():
        harness.log('no CUDA card: the benchmark runs on the card only')
        return 2
    if torch.cuda.device_count() < wl['chips']:
        harness.log(f'{wl["name"]} needs {wl["chips"]} cards, '
                    f'{torch.cuda.device_count()} present')
        return 2
    dev = torch.device('cuda', 0)
    harness.log(f'[card] {card_line()}; torch {torch.__version__}, '
                f'CUDA {torch.version.cuda}')
    ctx = harness.Context(bench, wl, args.seed, args.seconds,
                          bool(args.trace), dev, T_START)
    ctx.setup['import'] = import_s
    res = spec.loop(ctx.traffic['loop']).run(ctx)
    found = guard.forbidden_modules()
    if found:
        harness.log(f'forbidden modules loaded: {", ".join(found)}')
        return 3
    info = dict(platform='gpu', kind=torch.cuda.get_device_name(dev),
                count=wl['chips'])
    harness.print_result(harness.result_line(ctx, res, info))
    return 0


if __name__ == '__main__':
    sys.exit(main())
