#!/usr/bin/env python3
"""The rasterizer's z-test and the fit of this tree beside another tree's,
in one process on one CUDA card.

    python3 zmin_compare.py OTHER_DIR

OTHER_DIR holds another tree of this repository, e.g. an earlier commit
unpacked by ``git archive <commit> | tar -x -C OTHER_DIR`` into a directory
that .gitignore lists. In the three cases of chip_smoke.py's phase 6 (a
512^2, batch-4 render of FitConfig's defaults: the GT mesh at K 256 + 64
and at 4096 + 64, the noise-soup start of a fit at 4096 + 64) both trees'
z-tests compute both depth layers: the other tree's ids and z must equal
this tree's, and each is timed in turns (other, this, this, other) by
torch.profiler device time and by CUDA events. Then each tree runs
``main --mode fit_dmtets`` as phase 7 does, in the same turns, for its
seconds a step run and its peak device memory. A tree whose ``tile_zmin``
takes the padded candidate tensor (``tile_zmin(cand, ids, z_floor, ntx,
tpv)``, one launch a layer) is driven through that interface.

Exits non-zero when CUDA is unavailable or the two trees' z-tests differ.
"""

import importlib
import importlib.util
import inspect
import logging
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
TURNS = ('other', 'this', 'this', 'other')


def _load(path: str):
    """The package of the tree at ``path``, imported as ``mdt_other``
    beside this tree's (it imports itself relatively; its kernels build into
    its own ``_build/``)."""
    pkg = os.path.join(os.path.abspath(path), 'meshdiffusion_tpu_torch')
    spec = importlib.util.spec_from_file_location('mdt_other', os.path.join(pkg, '__init__.py'),
                                                  submodule_search_locations=[pkg])
    sys.modules['mdt_other'] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules['mdt_other'])
    return importlib.import_module('mdt_other.ops')


def _other_call(oops, zargs, res):
    """(a call of the other tree's z-test for both layers on these inputs,
    its launches a call)."""
    import torch
    if 'coords' in inspect.signature(oops.tile_zmin).parameters:
        return (lambda: oops.tile_zmin(*zargs, res, num_layers=2)), 1
    from meshdiffusion_tpu_torch.ops.tile_zmin import padded_candidates
    H, W = res
    assert H % 32 == 0 and W % 32 == 0      # no pixel past the image to mask
    B, N = zargs[0].shape[0], zargs[1].shape[0]
    cand, ids = padded_candidates(*zargs)
    floor0 = torch.full((N, 32, 32), -1e30, device=cand.device)

    def call():
        t0, z0 = oops.tile_zmin(cand, ids, floor0, W // 32, N // B)
        t1, z1 = oops.tile_zmin(cand, ids, torch.where(t0 >= 0, z0, 1e30), W // 32, N // B)
        return torch.stack([t0, t1]), torch.stack([z0, z1])
    return call, 2


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('other', help='the directory of the other tree')
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('zmin_compare: torch.cuda.is_available() is false', file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.fitting.fit import FitConfig
    from meshdiffusion_tpu_torch.main import main as this_main
    print(cs._smi())
    dev = torch.device('cuda')
    oops = _load(args.other)
    oops._build.lib()
    ops._build.lib()
    res = FitConfig().train_res
    rec = cs._Records()
    for name in ('meshdiffusion_tpu_torch', 'mdt_other'):
        logging.getLogger(name).addHandler(rec)
    tmp = tempfile.mkdtemp(prefix='zmin_compare_')
    try:
        gt = os.path.join(tmp, 'gt.obj')
        cs.gt_mesh(gt)
        for name, K, zargs, _ in cs.zmin_cases(gt, dev):
            with torch.inference_mode():
                this = lambda: ops.tile_zmin(*zargs, res, num_layers=2)
                other, per_call = _other_call(oops, zargs, res)
                (kt, kz), (ot, oz) = this(), other()
                assert torch.equal(kt, ot) and torch.equal(kz, oz), name
                turns = []
                for who in TURNS:
                    fn, n = (other, per_call) if who == 'other' else (this, 1)
                    dms, seen, issued = cs._kernel_ms(fn, 'tile_zmin', n)
                    turns.append(f'{who} {cs._ms(dms)} ms device ({seen} of {issued} launches '
                                 f'recorded), {cs._time_ms(fn, 20):.4f} ms CUDA events')
            print(f'tile_zmin {name}: the other tree ({per_call} launches a call) gives the same '
                  f'ids and z; both layers a call: ' + '; '.join(turns))
        entries = {'other': importlib.import_module('mdt_other.main').main, 'this': this_main}
        for i, who in enumerate(TURNS):
            _, peak, passes = cs.fit_run(entries[who], rec, gt, os.path.join(tmp, f'fit{i}'))
            cs.show_fit(f'{who}: ', passes, peak)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
