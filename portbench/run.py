#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Makes the cell's weights and inputs from the
seed on the card, warms up every shape the cell uses (set-up), drives the
port (``meshdiffusion_tpu_torch``) for ``--seconds``, checks what the timed
path produced against the plain reference under ``portbench/reference``,
and prints one JSON line: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics from a torch.profiler
window. Exits non-zero with no result where there is no CUDA card, or
fewer than the cell asks for, or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.setup_env()
    cell = harness.Cell.load(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'portbench: the cell needs {cell.chips} CUDA device(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} available',
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    driver = importlib.import_module(f'portbench.drivers.{cell.driver}')
    out = driver.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     device=torch.device('cuda', 0), t_start=T_START)
    bad = harness.foreign_modules()
    if bad:
        print(f'portbench: modules of JAX or the JAX package were loaded: {bad}',
              file=sys.stderr)
        return 4
    line = harness.result(cell, out, bool(args.trace), torch.cuda.get_device_name(0))
    harness.emit(line, out.checks)
    return 0


if __name__ == '__main__':
    sys.exit(main())
