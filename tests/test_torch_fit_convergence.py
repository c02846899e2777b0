"""The fit-quality gate on the port (the JAX package's
tests/test_fit_convergence.py ``test_pass1_fit_converges``): a short pass-1
fit of the radius-0.3 sphere on the tiny tet grid must converge, under each
edge-AA implementation, by the JAX gate's own thresholds: from each of a
few seeds, the chamfer distance below 0.025, the image loss's last quartile
below a tenth of its first, the learned light moved and kept non-negative;
over the seeds, the mean chamfer below half the mean start.

The gate is ``chip_smoke.fit_gate``, which the card runs in phase 24 (b):
48^2, batch 1, 120 iterations, ``learn_light``, a GT pool of 8, capacities
regrown as the fit driver regrows them. Marked slow, as JAX's is: on the CPU
an arm takes minutes a seed."""

import numpy as np
import pytest
import torch

import chip_smoke
from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid

pytest_plugins = ('torch_rules',)


@pytest.mark.slow
@pytest.mark.parametrize('impl', chip_smoke.AA_IMPLS)
def test_pass1_fit_converges(tiny_tet_grid, tmp_path, impl):
    tg = TetGrid.from_arrays(tiny_tet_grid.resolution, tiny_tet_grid.verts, tiny_tet_grid.indices)
    own = chip_smoke.tiny_tet_grid()
    np.testing.assert_array_equal(own.verts, tg.verts)        # the card's copy of the grid
    np.testing.assert_array_equal(own.indices, tg.indices)
    with chip_smoke.aa_impl(impl):
        runs = [chip_smoke.fit_gate(tg, str(tmp_path), torch.device('cpu'), seed)
                for seed in chip_smoke.GATE_SEEDS]
    for r in runs:
        print(f'MEASURED {impl} seed={r["seed"]} cd0={r["cd0"]:.5f} cd1={r["cd1"]:.5f} '
              f'img_first_q={r["img_first_q"]:.5f} img_last_q={r["img_last_q"]:.5f}')
    assert chip_smoke.gate_failures(runs) == [], runs
