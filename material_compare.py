#!/usr/bin/env python3
"""The neural material and the textured fit of this tree beside another
tree's, in one process on one CUDA card.

    python3 material_compare.py OTHER_DIR

OTHER_DIR holds another tree of this repository, e.g. an earlier commit
unpacked by ``git archive <commit> | tar -x -C OTHER_DIR`` into a directory
that .gitignore lists. Both trees' ``MLPTexture3D`` (full size: 16 levels x
2^19 x 2 table, 2 x 32 hidden, 9 outputs), with the other's weights
copied into this one's, take the forward and backward of a fit step's
samples (1,048,576 points): the outputs and the table's gradients must
agree, and each is timed in turns (other, this, this, other) by CUDA
events, torch.profiler device time and the number of kernels it launches.
Then each tree runs the textured ``main --mode fit_dmtets`` of
chip_smoke.py's phase 19 (``normal_only`` false, the sky .hdr,
``random_lgt``; no validation or bake) in the same turns, for its seconds a
step run by pass and its peak device memory.

Exits non-zero when CUDA is unavailable or the two materials differ.
"""

import importlib
import logging
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
TURNS = ('other', 'this', 'this', 'other')
POINTS = 1 << 20                     # 4 views x 2 layers x shade_cap 65,536 x 2 (the jitter)


def _fwd_bwd(mat, x, up):
    def run():
        mat.zero_grad(set_to_none=True)
        (mat(x) * up).sum().backward()
    return run


def _kernels(fn) -> tuple:
    """(device ms, kernels launched) of one call of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    events = [e for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(cs._dev_us(e) for e in p.key_averages()) / 1000.0, len(events)


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('other', help='the directory of the other tree')
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('material_compare: torch.cuda.is_available() is false', file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from zmin_compare import _load
    from meshdiffusion_tpu_torch.fitting import fit as fit_mod
    from meshdiffusion_tpu_torch.main import main as this_main
    print(cs._smi())
    dev = torch.device('cuda')
    _load(args.other)
    ofit = importlib.import_module('mdt_other.fitting.fit')
    aabb = ((-0.6, -0.6, -0.6), (0.6, 0.6, 0.6))
    omat = ofit.make_mlp_material(aabb, device=dev)
    mat = fit_mod.make_mlp_material(aabb, device=dev)
    mat.load_state_dict(omat.state_dict())
    g = torch.Generator(device=dev).manual_seed(5)
    x = (torch.rand((POINTS, 3), device=dev, generator=g) - 0.5) * 1.4
    up = torch.randn((POINTS, 9), device=dev, generator=g)
    fns = {'other': _fwd_bwd(omat, x, up), 'this': _fwd_bwd(mat, x, up)}
    with torch.no_grad():
        a, b = omat(x), mat(x)
    fns['other']()
    fns['this']()
    ga, gb = omat.encoder.table.grad, mat.encoder.table.grad
    rel = float((ga - gb).norm() / ga.norm())        # index_add's fp32 atomics: any order
    print(f'material forward at {POINTS} points: max |this - other| '
          f'{float((a - b).abs().max()):.3e} (bit-equal: {torch.equal(a, b)}); the table\'s '
          f'gradient: rel. L2 {rel:.3e}')
    torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-5)
    assert rel <= 1e-5, rel
    turns = []
    for who in TURNS:
        dms, n = _kernels(fns[who])
        turns.append(f'{who} {cs._time_ms(fns[who], 10, 2):.3f} ms CUDA events, {dms:.3f} ms '
                     f'device, {n} kernels')
    print('material forward + backward: ' + '; '.join(turns))
    del omat, mat, x, up, fns, a, b, ga, gb

    rec = cs._Records()
    for name in ('meshdiffusion_tpu_torch', 'mdt_other'):
        logging.getLogger(name).addHandler(rec)
    entries = {'other': importlib.import_module('mdt_other.main').main, 'this': this_main}
    tmp = tempfile.mkdtemp(prefix='material_compare_')
    try:
        gt = cs.textured_gt(os.path.join(tmp, 'gt'))
        hdr = os.path.join(tmp, 'sky.hdr')
        cs.sky_hdr(hdr)
        cfg = {'normal_only': False, 'envmap': hdr, 'random_lgt': True}
        for i, who in enumerate(TURNS):
            run = cs.textured_fit_run(entries[who], rec, gt, os.path.join(tmp, f'tex{i}'), cfg,
                                      cs.TEX_ITERS, dev)
            cs.show_fit(f'{who}: textured ', run['passes'], run['peak'])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
