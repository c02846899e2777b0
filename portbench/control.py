#!/usr/bin/env python3
"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell's driver at the cell's own size (a
short window: long enough to reach every checked step) with the control
beside the program: the plain reference put in the program's place in the
nearest precision below the configuration's (the U-Net's conv, matmul and
attention operands rounded to fp8 e4m3 with a per-tensor scale, for bf16;
the update in bf16, for its fp32 state). Prints one JSON line a seed: the
program's and the control's readings of each compared number. The
benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    args = p.parse_args(argv)
    harness.setup_env()
    import torch
    if not torch.cuda.is_available():
        print('control: needs a CUDA card', file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    for seed in args.seeds:
        cell = harness.Cell.load(args.workload)
        driver = importlib.import_module(f'portbench.drivers.{cell.driver}')
        out = driver.run(cell, seed=seed, seconds=args.seconds, trace=False,
                         device=torch.device('cuda', 0), t_start=time.perf_counter(),
                         control=True)
        print(json.dumps({'cell': cell.name, 'seed': seed,
                          'checks': {c.name: c.value for c in out.checks},
                          'readings': cell.readings,
                          'ms_per_sample_step': out.measured['ms_per_sample_step']}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
