"""The plain reference against the port at a tiny width on the CPU, in
fp32: the U-Net from the same weights, the grid mask, the schedule and the
ancestral update."""

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.reference import gridmask, sde as ref_sde, unet as ref_unet
from portbench.tests.tiny import tiny_config


@pytest.mark.parametrize('cell', ['gen64-b1', 'gen128-b7'])
def test_reference_unet_matches_the_port_in_fp32(cell):
    from portbench.drivers.gen import port_config
    from meshdiffusion_tpu_torch.models import create_model
    cfg = tiny_config(harness.Cell.load(cell).config)
    a = ref_unet.arch(cfg)
    R, B = a['R'], 2
    config = port_config(cfg, B)
    config.gpu.compute_dtype = 'float32'
    model = create_model(config, 'cpu').eval()
    _, p = weights.make(a, 2 ** 40 + 3, 'cpu')
    model.load_state_dict(p, strict=True)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, R, R, R, a['C'], generator=g)
    mask = torch.as_tensor(gridmask.load(R))
    labels = torch.tensor([998.0, 17.5])
    with torch.no_grad():
        got = model(x, labels, mask[None, ..., None])
        ref = ref_unet.forward(p, a, x.permute(0, 4, 1, 2, 3), labels, mask)
    ref = ref.permute(0, 2, 3, 4, 1)
    assert float(ref.norm()) > 1.0
    assert float((got - ref).norm() / ref.norm()) < 1e-5


def test_weights_are_the_seeds():
    a = ref_unet.arch(tiny_config(harness.Cell.load('gen64-b1').config))
    f1, p1 = weights.make(a, 11, 'cpu')
    f2, _ = weights.make(a, 11, 'cpu')
    f3, _ = weights.make(a, 12, 'cpu')
    assert torch.equal(f1, f2) and not torch.equal(f1, f3)
    assert p1['all_modules.3.GroupNorm_0.weight'].min() > 0.89
    assert float(p1['all_modules.3.Conv_1.weight'].abs().max()) > 1e-3


@pytest.mark.parametrize('R', [64, 16])
def test_grid_mask_matches_the_port(R):
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    import os
    if R == 64:
        cfg = harness.Cell.load('gen64-b1').config
        ours = gridmask.load(R, os.path.join(harness.ROOT, cfg['tet_file']))
    else:
        ours = gridmask.load(R)
        from meshdiffusion_tpu_torch.geometry.generate_tets import generate_tet_grid
        grid = TetGrid.from_arrays(R, *generate_tet_grid(R))
    grid = TetGrid.load(64) if R == 64 else grid
    assert np.array_equal(ours, grid.grid_mask())


def test_schedule_and_update_match_the_port():
    from meshdiffusion_tpu_torch.diffusion.sampling import StepTables
    from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
    from meshdiffusion_tpu_torch.ops import ancestral_update_reference
    sched = ref_sde.Schedule(0.1, 20.0, 1000)
    tab = StepTables.build(VPSDE(0.1, 20.0, 1000))
    g = torch.Generator().manual_seed(1)
    x, e, z = (torch.randn(2, 8, 8, 8, 4, generator=g) for _ in range(3))
    m = (torch.rand(1, 8, 8, 8, 1, generator=g) > 0.3).float()
    for i in (0, 1, 500, 998):
        label, beta, std = sched.step(i)
        assert label == pytest.approx(float(tab.labels[i]), rel=1e-6)
        assert beta == pytest.approx(float(tab.beta[i]), rel=1e-6)
        assert std == pytest.approx(float(tab.std[i]), rel=1e-6)
        want, _ = ancestral_update_reference(x, e, m, z, float(tab.beta[i]), float(tab.std[i]))
        got = ref_sde.ancestral_update(x, e, z, m, beta, std)
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
