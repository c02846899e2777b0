#!/usr/bin/env python3
"""Smoke test of the PyTorch port (meshdiffusion_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Drives the port's paths through their hand-written kernels, and fails
(non-zero exit, no result line) on any error: res64 unconditional
generation at full width (nf 128, ch_mult (1,1,2,4,4), 3 ResnetBlocks a
level, attention at 16^3, batch 1, the bundled 64 tet grid); DMTet
dataset fitting at full width (FitConfig's defaults: 512^2, batch 4, the
64 tet grid, raster_K 256 + raster_Kg 64, compact shading and AA), cut in
iterations only; single-view conditional generation (fit_singleview
at FitConfig's defaults -> cond_gen at full width from a reference-format
checkpoint -> extract), with DDIM interpolation; res64 diffusion
training at full width, effective batch 48, cut in steps; the data tools
(fitted dict -> training grid); res128 generation at the preset's full
width and batch 7 on the generated 128 tet grid, with extraction on its
12,002,256 tets and ``extract --save_viz``; the likelihood on the res64
model; and the textured fit (the hash-grid neural material under an HDR
sky with random light rotations, validation renders and the UV-baked
export) at FitConfig's defaults; and training on rank meshes, every rank
a process on this card joined by gloo: res64 at full width on a (2, 2)
(data, spatial) mesh and res128 on (1, 2), the grid's depth split over the
spatial axis; and the edge-AA alternates (``MESHDIFFUSION_AA_IMPL``
compact, flat and vmap) at the fit's full width, with the fit-quality gate
under each. Phases, in order:

1. the card: name and power limit, versions; TF32 off for fp32 comparisons;
2. the build: nvcc compiles csrc/*.cu for sm_90a (no prebuilt library);
3. every kernel against its plain PyTorch version at the main path's shapes
   (K3 and the GroupNorm statistics at every distinct ResnetBlock conv
   shape, captured from a forward, each K3 call on the A operand's route its
   plan gives, and K3 at gen64-b4's hot shape (4, 64^3, 128) -> 128 on the
   descriptor route; the per-shape rows also go to
   ``DIR/kernel_shapes.json``, ``DIR`` defaulting to ``chip_smoke_out/``
   beside this file), with errors, bounds and CUDA-event times
   (warm) of kernel and plain; for K3 and the statistics also the device
   time from torch.profiler beside the CUDA-event time (the host's share
   shows at the small levels), the bound, and ``library_ms``: one PyTorch
   call for the same function (``torch.var_mean`` for the statistics, its
   CUDA-event and its device time; for K3
   there is none, so ``library_ms`` is null and cuDNN's ``F.conv3d`` alone
   on the already-normalized bf16 input stands beside it as a conv-only
   yardstick, ``conv_only_ms``);
4. the full-width U-Net forward (seeded normal(0, 0.02) weights, bf16) with
   kernels against without, the launch counts of one forward (28 of K3's
   74 on the descriptor route), and the device time of each kernel in a
   U-Net step (one forward and one ancestral update) over a few profiled
   steps, with the card's busy share of a warm step's wall time;
5. the entry points, ``main --mode uncond_gen`` (num_scales 10, beta_max
   2.0) then ``main --mode extract``, with every launch counter set to 0
   just before and read just after the generation run;
6. the tile z-test kernel against its plain version at the fit path's
   shapes, every depth layer in one launch, in three cases of a 512^2,
   batch-4 render: the GT mesh (a torus united with a box, marching tets
   on the 64 grid, written with geometry/obj_io.py) binned at the GT
   renders' capacity K 256 + Kg 64, the same binned at 4096 + 64 (the
   capacity a fit grows to), and the fit's own pass-1 start (the noise-soup
   mesh of ``DMTetFitter.init_state`` on the 64 grid) at 4096 + 64; ids
   equal and z bit-equal on both layers, with device time (torch.profiler)
   and CUDA-event time, the bound, the live (candidate, tile) pairs and the
   heaviest tile's count of each; the device time counts only when
   torch.profiler recorded at least half the launches of its window and it
   fits in the CUDA-event time, else it is printed as not measured;
7. the entry point ``main --mode fit_dmtets`` on the GT mesh (10 iterations
   a pass, a pool of 4 GT view batches), every launch counter set to 0
   just before and read just after: tile_zmin runs once a render, both
   layers of all 4 views, so once per GT render and fit step run; both
   dicts written with the JAX package's keys and shapes, signs in pass 2,
   every loss finite; seconds a step run and the peak device memory above
   what was held before the fit;
8. the entry point ``main --mode fit_singleview`` on the GT mesh
   (FitConfig's defaults, SV_ITERS iterations, the GT bootstrap every 10):
   tile_zmin launches once a render (the GT target, every step, the
   one-layer visibility render), whose one-layer z-test is held against
   its plain version (ids equal, z bit-equal) and timed beside its bound;
   the dict {sdf, deform, vis, vis_rast} with its shapes, sdf in {-1, +1},
   0 < vis < V, vis_rast containing vis; seconds a step, peak device
   memory, the largest overflow counts (the single-view fit grows no
   capacity, as in the JAX package);
9. a checkpoint in the reference's format written by
   ``utils/checkpoint.py`` from the seeded full-width model (module.
   keys, an EMA list of values distinct from the weights), loaded onto a
   fresh eval model: every parameter bit-equal to its EMA entry;
10. ``main --mode cond_gen`` at full width, batch 1 (num_scales 10,
    beta_max 2.0, freeze_iters 8) from that checkpoint and phase 8's dict,
    counters set to 0 just before and read just after; the sample finite,
    zero outside the grid mask, its SDF sign agreeing with the partial's
    at more than 0.6 of the visible vertices; then ``main --mode extract``
    (no remesh) to a non-empty .obj;
11. ``main --mode uncond_gen_interp`` (DDIM, the default 1000 scales and
    100-step quad schedule, batch 2, the checkpoint's EMA weights): 99
    forwards' launches and no ancestral update;
12. ``main --mode train`` at the res64 preset's full width (dropout 0.1,
    bf16, remat on) on TRAIN_GRIDS synthetic 64^3 grids through the native
    loader, effective batch 48 as micro-batch TRAIN_MICRO x iter_size
    TRAIN_ITER, steps 0..TRAIN_STEPS (one warm, the rest timed by the
    trainer's own log, loader and copy included, with each step's device
    span beside it), counters
    set to 0 just before and read just after: K3 and the statistics 2 x 37
    a micro-batch (forward and remat recompute of chain 0; chain 1 runs
    decomposed under dropout); every loss finite, the weights unchanged by
    step 0 (lr 0 under warm-up) and changed by the last, the EMA counting
    every step, the preemption snapshot read back by ``load_eval_weights``,
    no module of jax, TensorFlow or the JAX package imported by the run;
    then, on the trained state: one micro-batch step under torch.profiler
    (device ms by family, the card's busy share), the first step's weight
    repacking, peak memory at micro-batch 2 and TRAIN_MICRO, and at
    micro-batch 2 with dropout 0 (both chains through K3) the loss and
    every gradient with kernels against the plain versions (``ops.plain()``);
13. the data tools on phase 7's fitted dict: ``data.convert tets-to-3dgrid``
    on the card (its grid's ``grid_to_tet`` gives back the dict's sdf sign and
    clipped deform exactly), ``get-tet-mask`` bit-equal to the 64 grid's
    mask, ``save-meta``, and the port's dataset reading the grid;
14. the 128 tet grid generated on the host with its cache removed (the cache
    under a temporary ``XDG_CACHE_HOME``), then read back from the cache:
    seconds, V / T / E, and (R-1)^3 ones in its mask;
15. every kernel at the res128 preset's shapes (nf 128, ch_mult (1,1,2,4,4,4),
    seeded normal(0, 0.02) weights): K3 and the statistics at each distinct
    conv shape of a batch-1 forward, as phase 3; at batch 7 the level-0 conv
    shapes (up to 3.76e9 elements, past 2^31), the ancestral update and the
    output head, each sample held against the plain version of that sample;
    the batch-1 forward kernels against plain; one batch-7 forward with the
    kernels: its launches (K3 64, 20 of them on the descriptor route,
    statistics 65), time, device time by kernel
    and peak device memory; the per-shape rows also go to
    ``DIR/kernel_shapes.json`` and the phase's numbers to ``DIR/res128.json``;
16. ``main --config res128 --mode uncond_gen`` at the preset's batch 7
    (num_scales 10, beta_max 2.0) on the 128 grid's mask, every counter set
    to 0 just before and read just after, the sample finite and zero outside
    the mask; then ``main --mode extract --resolution 128 --no_remesh`` of its
    first sample: marching tets' seconds and the peak device memory;
17. the GT shape's SDF sign on the 128 grid scattered by
    ``data.convert.tets_to_grid`` on the card, then ``main --mode extract
    --resolution 128 --save_viz`` with the full post-process, counters set to
    0 just before and read just after: a non-empty .obj, a 512^2 PNG that is
    not uniform, tile_zmin launched once a render (a render whose binning
    overflows is redone with the capacities grown; the last drops nothing)
    and held bit-equal to its plain version on the last;
18. the likelihood on the res64 model at full width, batch 1, on phase 13's
    grid: the drift and the Hutchinson divergence at t = 1e-3, 0.5, 1 with
    kernels (K3 forward under autograd, 74 launches an evaluation) against
    the plain versions (``ops.plain()``); then ``likelihood_fn`` (rtol = atol = 1e-3) from start to
    end on the seeded init, whose epsilon is ~0, held to the closed-form
    bits/dim: nfe, bits/dim, seconds;
19. ``main --mode fit_dmtets`` on a textured GT (the torus united with the
    box, box-projected texture coordinates, an .mtl with ``bsdf diffuse``
    and a ``map_Kd`` PNG) with ``normal_only`` false, a 256x512 RGBE sky
    with a sun as ``envmap``, ``random_lgt``, ``validate`` (8 views) and
    ``save_baked``, 10 iterations a pass, counters set to 0 just before and
    read just after: both dicts, every loss finite, every parameter of the
    neural material moved, tile_zmin once a render (the fit's, two a
    validation view, the 1024^2 UV bake's), metrics.txt with 8 rows and
    the averages, the baked .obj, .mtl and maps read back with a
    non-uniform kd; the first fit step's z-test and the bake's (every
    candidate at z = 0, where the tie-break picks each texel) held
    bit-equal to plain; s/step, pass 1's step at iteration 5 under
    torch.profiler (device ms by kernel family), the material's forward
    and backward at a step's 1,048,576 samples, peak memory,
    ``parametrize``'s host seconds; numbers to ``DIR/textured.json``;
20. the same fit with ``learn_light`` in place of the sky, 3 iterations a
    pass; then ``main --mode fit_singleview`` under the sky (10 iterations,
    tile_zmin 1 + 10 + 1);
21. the two modes the spatially sharded U-Net runs, at every distinct conv
    shape of a res64 forward at PAR_MICRO samples, the depth split over 2 and
    4 slabs (halos (0, 1), (1, 1), (1, 0)): ``gn_moments`` (the statistics
    kernel's moments mode) of each slab against its plain version, merged
    and folded against the unsharded ``gn_affine`` (1e-6 relative to the
    affine's size); K3's depth-halo mode (``gn_silu_conv3d_halo``) on each
    slab against its plain version (relative L2 1e-2) and the slabs put
    together against the unsharded K3; CUDA-event and device times of a
    slab's call beside the unsharded kernels' at the same shapes, the
    bounds; per-case rows to ``DIR/kernel_shapes.json``;
22. res64 at full width on a (2, 2) mesh: 4 processes on this card, gloo
    (``gpu.dist_backend``), PAR_MICRO samples a data row x iter_size 2. One
    process runs a step on one seeded global batch and source (dropout 0),
    then the 4 ranks run it on their shares: rank 0's all-reduced gradient
    within relative L2 1e-2 of the one process's (bf16), every rank's
    weights bit-equal after it (a digest of their bytes), K3 only in its
    halo mode (4 x blocks a micro-batch: both chains, forward and remat
    recompute); then ``main --mode train`` on the mesh (the preset's dropout,
    steps 0..PAR_STEPS): s/step by the trainer's log, each rank's peak
    memory, its launches (2 x blocks halo launches a micro-batch), the
    gradient all-reduce's own seconds; then two ranks on this card under
    NCCL, whose device check must raise;
23. res128 at full width on a (1, 2) mesh (5^3 stem, 2-plane halos): 2
    processes, micro-batch 1, steps 0..R128_PAR_STEPS, held against one
    process running the res128 step at micro-batch 1 as phase 22 is, with
    each rank's peak memory beside the one process's; numbers of 21-23 to
    ``DIR/parallel.json``;
24. (a) the GT mesh of phase 7 rendered at 512^2, batch 4, two layers,
    through ``render_mesh`` under MESHDIFFUSION_AA_IMPL compact, flat and
    vmap (capacities grown until nothing drops): flat's and vmap's shaded
    image within max-abs 1e-5 of compact's and the gradient of a fixed
    image loss w.r.t. v_pos within relative L2 1e-4, aa_overflow 0 in each,
    each arm's tile_zmin call (one a render) bit-equal to plain, and each
    render's AA pass replayed under torch.profiler (device ms, forward and
    forward + backward); (b) the fit-quality gate of the JAX package
    (tests/test_fit_convergence.py) on the tests' 8^3 tet grid, copied here:
    the radius-0.3 sphere, 48^2, batch 1, 120 pass-1 iterations,
    ``learn_light``, a GT pool of 8, capacities regrown as the fit driver
    does, under each AA implementation, from seeds 1-4 of the card's own
    generator, held to JAX's thresholds (at every seed cd1 < 0.025, the
    last quartile's image loss < 0.10 of the first's, the light moved and
    >= 0; over the seeds mean cd1 < 0.5 mean cd0, since cd0 is the random
    start's), counters set to 0 before each arm and read after; then the
    AA ablation's arms (tools/aa_ablation.py: 150
    iterations at 64^2, AA on and off) with chamfer and 4-pose PSNR beside
    the JAX package's recorded numbers; numbers to ``DIR/aa_gate.json``;
24b. the DiT-XL/4 preset (``dit3d_xl4_res64``), after 24, since its large
    temporaries would leave the allocator's cache fragmented for the ranks
    of 22-23: its attention kernel against the plain version at batch 4
    and 1 (4096 tokens, 16 heads of 72), with its share of the bound, the
    bytes of K and V it reads a call, ptxas's log free of wgmma
    serialisation for it, and ``F.scaled_dot_product_attention`` timed
    beside it as ``library_ms``; a full-width forward's 28 launches and the
    kernel's device time a forward; ``main --config dit3d_xl4_res64 --mode
    uncond_gen`` 9 steps, launches counted;
24c. the DiT-MoE-XL/4 preset (``dit3d_moe_xl4_res64``), after 24b: its
    routed-expert kernels (``ops.moe_experts``) against the plain version
    at the cell's shapes (32,768 rows of batch 4 top 2 over 8 experts, D
    1152, F 4608) under the softmax's own routing, a skewed one and one
    that leaves six experts empty, with the per-expert loop of cuBLAS
    products timed beside it as ``library_ms``; a full-width forward's 56
    expert and 28 attention launches and the experts' device time a
    forward; ``main --config dit3d_moe_xl4_res64 --mode uncond_gen`` 9
    steps, launches counted;
24d. the FLUX.1 preset (``flux3d_dev_res64``), after 24c: at the cell's
    shapes (batch 4, 512 + 4096 joint tokens, 24 heads of 128) the dh-128
    attention against the plain version, with
    ``F.scaled_dot_product_attention`` timed beside it as ``library_ms``,
    and ``qk_norm_rope`` in both modes (two 3 D sources, one 7 D source)
    against its plain version, each with its bound and the share reached;
    a full-width forward at batch 4 with its 30 + 30 launches and each
    kernel's device time a forward; ``main --config flux3d_dev_res64 --mode
    uncond_gen`` 9 steps, launches counted (the kernels line's
    ``dit_attention`` row sums the dh-72 and dh-128 shapes);
25. a JSON line of each path's launches, one JSON line of kernel results
    (each kernel's launches summed over every path that runs it, its
    launches a forward or fit step, its bound and its ``library_ms``; for
    the statistics also ``library_device_ms``, torch.var_mean's device
    time), the card's name and power limit, and the last line
    ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when CUDA is unavailable or the package is
not beside this file.
"""

import contextlib
import gc
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _smi() -> str:
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          check=True).stdout.strip()


def _time_ms(fn, iters=10, warmup=2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profile(fn, iters):
    """torch.profiler's (CUPTI) averages by name over ``iters`` warm calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def _dev_us(e) -> float:
    return getattr(e, 'self_device_time_total', None) or getattr(e, 'self_cuda_time_total', 0)


def _device_ms(fn, iters=10) -> dict:
    """Device time a call of each kernel that ``fn`` launches: {kernel name:
    ms a call of fn}, warm."""
    out = {}
    for e in _profile(fn, iters):
        if _dev_us(e):
            out[e.key] = out.get(e.key, 0.0) + _dev_us(e) / iters / 1000.0
    return out


# kernel wrapper -> substrings of the names its kernels carry in a profile
_KERNEL_NAMES = {
    'ancestral_update': ('_ancestral_kernel',),
    'gn_affine': ('gn_stats_kernel',),
    'groupnorm_silu': ('_gn_silu_apply_kernel',),
    'gn_silu_conv3d': ('gn_silu_conv3d_kernel', 'splitk_reduce_kernel'),
    'tile_zmin': ('tile_zmin_kernel',),
    'nin_residual': ('nin_residual_kernel',),
    'dit_attention': ('dit_attention_kernel', 'dit_attention_dh128_kernel'),
    'qk_norm_rope': ('qk_norm_rope_kernel',),
    'moe_experts': ('moe_gate_up_kernel', 'moe_down_kernel'),
}


def _kernel_ms(fn, wrapper: str, per_call: int = 1, iters: int = 10, tries: int = 3):
    """Device time a call of ``fn`` spends in ``wrapper``'s kernel, which it
    launches ``per_call`` times, from the first of ``tries`` torch.profiler
    windows that recorded at least half the launches it issued: (the mean
    over the recorded launches times ``per_call``, launches recorded,
    launches issued). (The profiler has dropped some or all of the
    cluster-launched z-test's records in a window, so the sum over a window
    undercounts.) The time is None, not measured, if no window did."""
    issued, n = iters * per_call, 0
    for _ in range(tries):
        hits = [e for e in _profile(fn, iters) if any(k in e.key for k in _KERNEL_NAMES[wrapper])]
        n = sum(e.count for e in hits)
        if 2 * n >= issued:
            return sum(_dev_us(e) for e in hits) / n * per_call / 1000.0, n, issued
    return None, n, issued


def _ms(t) -> str:
    return 'not measured' if t is None else f'{t:.4f}'


def _of(prof: dict, wrapper: str) -> float:
    return sum(t for k, t in prof.items() if any(n in k for n in _KERNEL_NAMES[wrapper]))


def _window_ms(fn, expected: dict, iters: int = 1):
    """One torch.profiler window over ``iters`` calls of ``fn``, which
    launches ``expected[wrapper]`` kernels of each wrapper a call: (device
    ms a call over every kernel, {wrapper: device ms a call}, {wrapper:
    launches recorded}); a wrapper whose main kernel was recorded fewer than
    half the times it was launched reads None, not measured, and so does the
    total then (the profiler has dropped records late in a long run)."""
    evs = _profile(fn, iters)
    ms, seen = {}, {}
    for n, names in _KERNEL_NAMES.items():
        hits = [e for e in evs if any(k in e.key for k in names)]
        seen[n] = sum(e.count for e in evs if names[0] in e.key)
        ms[n] = (sum(_dev_us(e) for e in hits) / iters / 1000.0
                 if 2 * seen[n] >= iters * expected.get(n, 0) else None)
    total = sum(_dev_us(e) for e in evs) / iters / 1000.0
    if any(ms.get(n, 0.0) is None for n in expected):
        total = None
    return total, ms, seen


def _window_full(fn, expected: dict, iters: int, tries: int = 3) -> dict:
    """Device ms a call of ``fn`` by wrapper ({wrapper: launches a call}),
    from the first of ``tries`` torch.profiler windows that recorded every
    launch of each (the profiler drops records late in a long run, and a
    window missing some would read low); None, not measured, for a wrapper
    that no window recorded in full."""
    out = {n: None for n in expected}
    for _ in range(tries):
        _, ms, seen = _window_ms(fn, expected, iters)
        for n in expected:
            if out[n] is None and seen[n] == iters * expected[n]:
                out[n] = ms[n]
        if all(v is not None for v in out.values()):
            break
    return out


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def _launches(**counts) -> dict:
    """The launch counts expected of every kernel wrapper: ``counts`` for
    the wrappers named, 0 for every other wrapper of ``ops.KERNEL_WRAPPERS``."""
    from meshdiffusion_tpu_torch import ops
    want = dict.fromkeys(ops.launch_counts(), 0)
    assert set(counts) <= set(want), counts
    return {**want, **counts}


def _plain(fn, *args):
    """``fn(*args)`` with every kernel wrapper on its plain version."""
    from meshdiffusion_tpu_torch import ops
    with ops.plain():
        return fn(*args)


class _Records(logging.Handler):
    """Keeps the fields the port's drivers log: timings (sample_s,
    postprocess_s, ...), each fit pass's (pass, iterations, steps run,
    seconds, pool seconds), the logged fit losses, the single-view
    fit's (iterations, seconds, largest overflow counts), and the trainer's
    log lines (step, loss, seconds, steps, loader seconds, loader)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.fields = {}
        self.fit_passes, self.fit_losses, self.train_logs = [], [], []

    def emit(self, record):
        for k in ('sample_s', 'steps', 'marching_s', 'postprocess_s', 'mesh_size',
                  'viz_renders', 'viz_overflow', 'validate', 'parametrize'):
            if hasattr(record, k):
                self.fields[k] = getattr(record, k)
        if hasattr(record, 'singleview_fit'):
            self.fields['singleview_fit'] = record.singleview_fit
        if hasattr(record, 'fit_pass'):
            self.fit_passes.append(record.fit_pass)
        if hasattr(record, 'fit_loss'):
            self.fit_losses.append(record.fit_loss)
        if hasattr(record, 'train_log'):
            self.train_logs.append(record.train_log)


def gt_sdf(verts):
    """The fit target's SDF at ``verts`` (V, 3), positive inside: a torus
    united with a box."""
    import numpy as np
    x, y, z = verts.T
    torus = np.sqrt((np.sqrt(x ** 2 + z ** 2) - 0.28) ** 2 + y ** 2) - 0.08
    q = np.abs(verts - [0.0, 0.1, 0.0]) - [0.12, 0.2, 0.12]
    box = np.linalg.norm(np.maximum(q, 0), axis=1) + np.minimum(q.max(1), 0)
    return -np.minimum(torus, box).astype(np.float32)


def gt_mesh(path: str) -> None:
    """The fit target: a torus united with a box, as marching tets of its
    SDF on the bundled 64 tet grid, written as an .obj."""
    import torch
    from meshdiffusion_tpu_torch.geometry.marching_tets import compact_mesh, marching_tets
    from meshdiffusion_tpu_torch.geometry.obj_io import write_obj
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    grid = TetGrid.load(64)
    sdf = gt_sdf(grid.verts)
    v, f = compact_mesh(marching_tets(grid, torch.from_numpy(grid.verts), torch.from_numpy(sdf)))
    write_obj(path, v, f)


def zmin_cases(gt_path: str, dev):
    """The z-test's inputs in phase 6's three cases, each a render of
    FitConfig's defaults (512^2, batch 4, Kg 64): [(name, K, zargs,
    overflow)], ``zargs`` the arguments of ``ops.tile_zmin`` before ``res``
    and ``overflow`` each view's (tile, global) binning overflow."""
    import numpy as np
    import torch
    from meshdiffusion_tpu_torch.fitting.dataset import TargetRenderer
    from meshdiffusion_tpu_torch.fitting.fit import FitConfig
    from meshdiffusion_tpu_torch.fitting.geometry import DMTetFitter
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    from meshdiffusion_tpu_torch.render import mesh as mesh_mod
    from meshdiffusion_tpu_torch.render import obj as obj_mod
    from meshdiffusion_tpu_torch.render import ops as render_ops
    from meshdiffusion_tpu_torch.render import rasterize as raster
    fcfg = FitConfig()
    B = fcfg.batch
    ref = obj_mod.load_mesh(gt_path, device=dev)
    ref = mesh_mod.auto_normals(mesh_mod.center_by_reference(ref, mesh_mod.aabb(ref.v_pos), 1.0))
    ren = TargetRenderer(ref_mesh=ref, envlight=None, cam_radius=fcfg.cam_radius,
                         train_res=fcfg.train_res)
    _, mvp, _ = ren.random_cameras(B, np.random.default_rng(0))
    mvp = torch.as_tensor(mvp, device=dev)
    fitter = DMTetFitter(grid=TetGrid.load(fcfg.dmtet_grid), scale=fcfg.mesh_scale,
                         deform_scale=fcfg.first_stage_deform)
    soup = fitter.get_mesh(fitter.init_state(torch.Generator(device=dev).manual_seed(0), dev))
    cases = []
    for name, m, fmask, K in (('GT, K 256 + 64', ref, None, fcfg.raster_K),
                              ('GT, K 4096 + 64', ref, None, 4096),
                              ('noise-soup start, K 4096 + 64', soup, soup.face_mask, 4096)):
        with torch.inference_mode():
            # the live-face capacity the fit grows raster_live to for this mesh
            live_cap = fcfg.raster_live
            n_live = m.t_pos_idx.shape[0] if fmask is None else int(fmask.sum())
            while live_cap < n_live:
                live_cap *= 2
            v_clip = render_ops.xfm_points(m.v_pos[None].expand(B, -1, -1), mvp)
            bins = raster.ViewBins(*zip(*(raster.tile_candidates(
                v_clip[b], m.t_pos_idx, fcfg.train_res, fmask, K, fcfg.raster_Kg, live_cap)
                for b in range(B))))
            zargs = (torch.stack(bins.coords), torch.cat(bins.tile_tris),
                     torch.cat(bins.tile_counts), torch.stack(bins.global_tris),
                     torch.stack(bins.global_count))
            over = [(int(a), int(b)) for a, b in zip(bins.tile_over, bins.global_over)]
        cases.append((name, K, zargs, over))
    return cases


def _var_mean_ms(xg):
    """torch.var_mean over (B, S, G, C/G), the statistics in one call:
    (CUDA-event ms, device ms from torch.profiler) a call."""
    import torch
    B, C = xg.shape[0], xg.shape[-1]
    v = xg.view(B, -1, 32, C // 32)
    call = lambda: torch.var_mean(v, dim=(1, 3), correction=0)
    return _time_ms(call, 20), sum(_device_ms(call).values())


def capture_conv_shapes(model, x, labels, mask):
    """The K3 / K2 input shapes of one plain forward (``ops.plain()``), with
    how often each runs: ({(x shape, dtype, O): calls}, the output head's
    {shape, dtype})."""
    import torch
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.models.layers import ResnetBlockDDPM
    conv_calls, head = {}, {}

    def _conv_hook(mod, args):
        for key in ((tuple(args[0].shape), args[0].dtype, mod.out_ch),
                    (tuple(args[0].shape[:-1]) + (mod.out_ch,), mod.dtype, mod.out_ch)):
            conv_calls[key] = conv_calls.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(_conv_hook)
             for m in model.modules() if isinstance(m, ResnetBlockDDPM)]
    hooks.append(model.all_modules[-1].register_forward_pre_hook(
        lambda mod, args: head.update(shape=tuple(args[0].shape), dtype=args[0].dtype)))
    with torch.inference_mode(), ops.plain():
        model(x, labels, mask)
    for h in hooks:
        h.remove()
    return conv_calls, head


def conv_shape_checks(conv_calls, dev, g, record, per_shape) -> None:
    """K3 and the GroupNorm statistics against their plain versions at every
    shape of ``conv_calls``: K3's relative L2 within 1e-2, a and b within
    1e-5, its A operand's route (``descriptor_launches``) the plan's;
    CUDA-event, device and plain times, the bound and the library call,
    recorded and appended to ``per_shape``."""
    import torch
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.ops import _build
    from meshdiffusion_tpu_torch.ops.gn_silu_conv import _plan, conv3d_same, gn_silu_conv3d_bound_ms
    from meshdiffusion_tpu_torch.ops.roofline import bound_ms
    with torch.inference_mode():
        for xs, xdt, O in sorted(conv_calls, key=lambda s: (-s[0][1], s[0][-1], s[2], str(s[1]))):
            C = xs[-1]
            xc = (torch.randn(xs, device=dev, generator=g) + 0.3).to(xdt)
            sc = 1.0 + 0.1 * torch.randn(C, device=dev, generator=g)
            bi = 0.1 * torch.randn(C, device=dev, generator=g)
            kern = (torch.randn((3, 3, 3, C, O), device=dev, generator=g)
                    / (27 * C) ** 0.5).to(torch.bfloat16)
            packed = ops.pack_conv_weights(kern)
            cb = 0.1 * torch.randn(O, device=dev, generator=g)
            route = _plan(*xs, O, _build.sm_count(dev.index or 0)).route
            d0 = ops.gn_silu_conv3d.descriptor_launches
            y = ops.gn_silu_conv3d(xc, sc, bi, kern, cb, packed=packed)
            assert ops.gn_silu_conv3d.descriptor_launches - d0 == route, (xs, O, route)
            r = ops.gn_silu_conv3d_reference(xc, sc, bi, kern, cb)
            rel = _rel_l2(y, r)
            err = float((y.float() - r.float()).abs().max())
            assert torch.isfinite(y).all() and rel <= 1e-2, (xs, O, rel)
            # K2's statistics at this input, against the plain version
            a, b = ops.gn_affine(xc, sc, bi)
            ra, rb = ops.gn_affine_reference(xc, sc, bi)
            torch.testing.assert_close(a, ra, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(b, rb, rtol=1e-5, atol=1e-5)
            err_s = max(float((a - ra).abs().max()), float((b - rb).abs().max()))
            call = lambda: ops.gn_silu_conv3d(xc, sc, bi, kern, cb, packed=packed)
            ms = _time_ms(call)
            pms = _time_ms(lambda: ops.gn_silu_conv3d_reference(xc, sc, bi, kern, cb))
            # device time from windows that recorded at least half the launches
            split = _plan(*xs, O, _build.sm_count(dev.index or 0)).splits > 1
            dms = _kernel_ms(call, 'gn_silu_conv3d', per_call=2 if split else 1)[0]
            dstats = _kernel_ms(call, 'gn_affine')[0]
            h = ops.groupnorm_silu_reference(xc, sc, bi).to(torch.bfloat16)
            lms = _time_ms(lambda: conv3d_same(h, kern))
            bnd, by = gn_silu_conv3d_bound_ms(xs, xdt, O)
            n = conv_calls[(xs, xdt, O)]
            record('gn_silu_conv3d', err, ms, pms, bnd, by)
            both = None if dms is None or dstats is None else dms + dstats
            per_shape.append({'name': 'gn_silu_conv3d', 'x': list(xs), 'dtype': str(xdt)[6:], 'O': O,
                              'route': ('registers', 'descriptor')[route],
                              'calls_per_forward': n, 'ms': ms, 'device_ms': dms,
                              'device_ms_with_stats': both, 'plain_ms': pms,
                              'bound_ms': bnd, 'bound_by': by, 'library_ms': None,
                              'conv_only_ms': lms})
            share = '' if dms is None else f', {100 * bnd / dms:.0f} % reached'
            print(f'K3 gn_silu_conv3d x{xs} {str(xdt)[6:]} -> O={O} (x{n} a forward, A by '
                  f'{("registers", "descriptor")[route]}): rel_l2 '
                  f'{rel:.3e} (bound 1e-2) max_abs_err {err:.3e}; call {ms:.4f} ms (CUDA events), '
                  f'device {_ms(dms)} ms (+ stats {_ms(dstats)}); plain {pms:.3f} ms; bound '
                  f'{bnd:.4f} ms ({by}{share}); cuDNN conv alone {lms:.4f} ms')
            s_ms = _time_ms(lambda: ops.gn_affine(xc, sc, bi), 20)
            s_pms = _time_ms(lambda: ops.gn_affine_reference(xc, sc, bi), 20)
            s_dms = _kernel_ms(lambda: ops.gn_affine(xc, sc, bi), 'gn_affine')[0]
            s_lms, s_ldms = _var_mean_ms(xc)
            s_bnd, s_by = bound_ms(*ops.gn_affine_cost(xs, xdt))
            record('gn_affine', err_s, s_ms, s_pms, s_bnd, s_by, s_lms, s_ldms)
            per_shape.append({'name': 'gn_affine', 'x': list(xs), 'dtype': str(xdt)[6:],
                              'calls_per_forward': n, 'ms': s_ms, 'device_ms': s_dms,
                              'plain_ms': s_pms, 'bound_ms': s_bnd, 'bound_by': s_by,
                              'library_ms': s_lms, 'library_device_ms': s_ldms})
            print(f'K2 gn_affine (gn_stats) x{xs} {str(xdt)[6:]}: max_abs_err {err_s:.3e} (bound '
                  f'1e-5); call {s_ms:.4f} ms, device {_ms(s_dms)} ms; plain {s_pms:.4f} ms; bound '
                  f'{s_bnd:.4f} ms ({s_by}); torch.var_mean {s_lms:.4f} ms, device {s_ldms:.4f} ms')


def nin_shape_checks(conv_calls, dev, g, record, per_shape) -> None:
    """The shortcut kernel against its plain version at every shortcut of
    ``conv_calls`` (a block's first chain whose width changes: its x shape,
    dtype and output width): relative L2 within 1e-5; CUDA-event, device and
    plain times and the bound, recorded and appended to ``per_shape``."""
    import torch
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.ops.roofline import PEAK_BF16_FLOPS, bound_ms
    short = {k: n for k, n in conv_calls.items() if k[0][-1] != k[2]}
    assert short, 'no shortcut among the captured calls'
    with torch.inference_mode():
        for (xs, xdt, N), n in sorted(short.items(), key=lambda kv: str(kv[0])):
            K = xs[-1]
            xc = torch.randn(xs, device=dev, generator=g).to(xdt)
            w = (torch.randn((K, N), device=dev, generator=g) * K ** -0.5).to(torch.bfloat16)
            b = 0.1 * torch.randn(N, device=dev, generator=g)
            h = torch.randn(xs[:-1] + (N,), device=dev, generator=g).to(torch.bfloat16)
            y = ops.nin_residual(xc, w, b, h)
            r = ops.nin_residual_reference(xc, w, b, h)
            rel = _rel_l2(y, r)
            err = float((y - r).abs().max())
            assert torch.isfinite(y).all() and rel <= 1e-5, (xs, xdt, N, rel)
            call = lambda: ops.nin_residual(xc, w, b, h)
            ms = _time_ms(call, 20)
            pms = _time_ms(lambda: ops.nin_residual_reference(xc, w, b, h), 20)
            dms = _kernel_ms(call, 'nin_residual')[0]
            bnd, by = bound_ms(*ops.nin_residual_cost(xs, xdt, N), PEAK_BF16_FLOPS)
            record('nin_residual', err, ms, pms, bnd, by)
            per_shape.append({'name': 'nin_residual', 'x': list(xs), 'dtype': str(xdt)[6:], 'N': N,
                              'calls_per_forward': n, 'rel_l2': rel, 'ms': ms, 'device_ms': dms,
                              'plain_ms': pms, 'bound_ms': bnd, 'bound_by': by})
            share = '' if dms is None else f', {100 * bnd / dms:.0f} % reached'
            print(f'nin_residual x{xs} {str(xdt)[6:]} -> N={N} (x{n} a forward): rel_l2 '
                  f'{rel:.3e} (bound 1e-5) max_abs_err {err:.3e}; call {ms:.4f} ms (CUDA events), '
                  f'device {_ms(dms)} ms; plain {pms:.4f} ms; bound {bnd:.4f} ms ({by}{share})')


DIT_STEPS = 9        # phase 24b: the DiT's uncond_gen steps (num_scales 10)


def dit_run(port_main, dev, g, record, per_shape) -> dict:
    """Phase 24b: the DiT-XL/4 preset (``dit3d_xl4_res64``). Its attention
    kernel against the plain version at the cell's batch 4 and at batch 1
    (4096 tokens, 16 heads of 72): relative L2 within 1e-2 per head,
    CUDA-event, device and plain times, the bound and the share of it
    reached, the bytes of K and V the kernel reads a call, and as
    ``library_ms`` ``F.scaled_dot_product_attention`` on the same q, k, v
    (timed beside it, never called by the port), after checking that the
    verbose build's ptxas log holds no wgmma serialisation warning for the
    kernel; a full-width forward (seeded weights,
    bf16), whose attention runs as 28 launches, with the kernel's device
    time a forward; then ``main --config dit3d_xl4_res64 --mode
    uncond_gen`` (num_scales 10, beta_max 2.0, batch 1) with every launch
    counted. Returns {'launches', 'device_ms_per_forward'}."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.config import get_config
    from meshdiffusion_tpu_torch.models import create_model
    from meshdiffusion_tpu_torch.ops.roofline import PEAK_BF16_FLOPS, bound_ms
    from meshdiffusion_tpu_torch.ops import _build
    H, dh, T = 16, 72, 4096
    # ptxas must not serialise the kernel's wgmma (C7510-C7517: registers short,
    # accumulators read in flight); the log is the verbose build's of phase 2
    log = _build.build_log.splitlines()
    serial = [ln for ln in log if 'C75' in ln and 'dit_attention' in ln]
    assert not serial, serial
    print(f'dit_attention_kernel: no wgmma serialisation in ptxas\'s {len(log)} build log lines')
    with torch.inference_mode():
        for B in (4, 1):
            qkv = torch.randn((B, T, 3 * H * dh), device=dev, generator=g).to(torch.bfloat16)
            y = ops.dit_attention(qkv, H)
            r = torch.cat([ops.dit_attention_reference(qkv[b:b + 1].float(), H)
                           for b in range(B)])
            yh, rh = y.float().reshape(B, -1, H, dh), r.reshape(B, -1, H, dh)
            rel = float(((yh - rh).norm(dim=(1, 3)) / rh.norm(dim=(1, 3))).max())
            err = float((yh - rh).abs().max())
            assert torch.isfinite(y).all() and rel <= 1e-2, (B, rel)
            del r, yh, rh
            call = lambda: ops.dit_attention(qkv, H)
            ms = _time_ms(call, 20)
            dms = _kernel_ms(call, 'dit_attention')[0]
            pms = _time_ms(lambda: ops.dit_attention_reference(qkv, H), 3, 1)
            q, k, v = qkv.reshape(B, -1, 3, H, dh).permute(2, 0, 3, 1, 4)
            lms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
            bnd, by = bound_ms(*ops.dit_attention_cost(B, qkv.shape[1], H, dh), PEAK_BF16_FLOPS)
            kv = ops.dit_attention_kv_bytes(B, qkv.shape[1], H, dh)
            if B == 4:          # the cell's batch: the kernels line's row
                record('dit_attention', err, ms, pms, bnd, by, lms)
            share = None if dms is None else 100 * bnd / dms
            per_shape.append({'name': 'dit_attention', 'qkv': list(qkv.shape), 'heads': H,
                              'rel_l2': rel, 'ms': ms, 'device_ms': dms, 'plain_ms': pms,
                              'library_ms': lms, 'bound_ms': bnd, 'bound_by': by,
                              'share_of_bound': share, 'kv_bytes': kv})
            print(f'dit_attention qkv{tuple(qkv.shape)} {H} heads of {dh}: rel_l2 {rel:.3e} '
                  f'(bound 1e-2 a head) max_abs_err {err:.3e}; call {ms:.4f} ms (CUDA events), '
                  f'device {_ms(dms)} ms; plain {pms:.2f} ms; scaled_dot_product_attention '
                  f'{lms:.4f} ms; bound {bnd:.4f} ms ({by}'
                  f'{"" if share is None else f", {share:.1f} % reached"}); '
                  f'K and V read {kv / 1e9:.3f} GB a call')
            del qkv, y, q, k, v

    cfg = get_config('dit3d_xl4_res64')
    R = cfg.data.image_size
    model = create_model(cfg, dev).eval()       # outside inference mode: its weights keep versions
    with torch.inference_mode():
        with torch.no_grad():
            for prm in model.parameters():
                prm.uniform_(-0.03, 0.03, generator=g)
        x = torch.randn((1, R, R, R, 4), device=dev, generator=g)
        lab, msk = torch.tensor([500.0], device=dev), torch.ones((1, R, R, R, 1), device=dev)
        model(x, lab, msk)
        ops.reset_launch_counts()
        model(x, lab, msk)
        torch.cuda.synchronize()
        per_fwd = ops.launch_counts()
        assert per_fwd == _launches(dit_attention=28), per_fwd
        fwd_dms = _kernel_ms(lambda: model(x, lab, msk), 'dit_attention', per_call=28, iters=3)[0]
        print(f'DiT-XL/4 full-width forward, batch 1, bf16: launches {per_fwd}; the attention '
              f'kernel {_ms(fwd_dms)} ms of device time a forward')
        del model, x

    tmp = tempfile.mkdtemp(prefix='chip_smoke_dit_')
    try:
        ops.reset_launch_counts()
        npy = port_main(['--config', 'dit3d_xl4_res64', '--mode', 'uncond_gen', '--device', 'cuda',
                         f'--config.model.num_scales={DIT_STEPS + 1}',
                         '--config.model.beta_max=2.0', '--config.eval.batch_size=1',
                         f'--config.eval.eval_dir={tmp}'])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        assert launches == _launches(ancestral_update=DIT_STEPS,
                                     dit_attention=28 * DIT_STEPS), launches
        sample = np.load(npy)
        assert sample.shape == (1, 4, R, R, R) and np.isfinite(sample).all()
        print(f'main --config dit3d_xl4_res64 --mode uncond_gen: {DIT_STEPS} steps; '
              f'launches {launches}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {'launches': launches, 'device_ms_per_forward': fwd_dms}


MOE_SHAPE = (16384, 8, 2, 1152, 4608)   # phase 24c: tokens (batch 4), E, k, D, F


def moe_case(dev, g, routing: str, shape=MOE_SHAPE):
    """(tokens, packed bf16 weights, order, offsets, routing weights, top k
    ids) at ``shape`` (N, E, k, D, F), drawn from ``g``: ``cell`` the
    softmax's top k of random logits; ``skewed`` every token's first slot
    on expert 3 and its second on expert 0 or 1; ``empty`` every pair on
    experts 0 and E - 1, the others without a row."""
    import torch
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.models.moe import route
    N, E, k, D, F = shape
    x = torch.randn((N, D), device=dev, generator=g).to(torch.bfloat16)
    gate, up = (torch.randn((E, F, D), device=dev, generator=g) * D ** -0.5 for _ in range(2))
    w_gu = ops.pack_gate_up(gate, up).to(torch.bfloat16)
    del gate, up
    w_down = (torch.randn((E, D, F), device=dev, generator=g) * F ** -0.5).to(torch.bfloat16)
    logits = torch.randn((N, E), device=dev, generator=g)
    if routing == 'skewed':
        logits[:, 3] += 100.0
        logits[:, :2] += 50.0
    elif routing == 'empty':
        logits[:, [0, E - 1]] += 100.0
    p, top, order, offsets = route(logits, k)
    return x, w_gu, w_down, order, offsets, p.reshape(-1).contiguous(), top


def moe_cublas_loop(x, w_gu, w_down, order, bounds, weights, k):
    """The per-expert loop of cuBLAS bf16 products that ``ops.moe_experts``
    replaces, the partition already on the host: gather, gate/up, SwiGLU,
    down, weight, scatter to pair order."""
    import torch
    import torch.nn.functional as F
    out = torch.empty((order.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    for e in range(w_gu.shape[0]):
        rows = order[bounds[e]:bounds[e + 1]].long()
        if not rows.numel():
            continue
        gu = F.linear(x.index_select(0, rows // k), w_gu[e]).view(rows.shape[0], -1, 2, 64)
        h = (F.silu(gu[:, :, 0].float()) * gu[:, :, 1].float()).to(x.dtype).flatten(1)
        out[rows] = F.linear(h, w_down[e]).float() * weights[rows, None]
    return out


def moe_run(port_main, dev, g, record, per_shape) -> dict:
    """Phase 24c: the DiT-MoE-XL/4 preset (``dit3d_moe_xl4_res64``). Its
    routed-expert kernels against the plain version at MOE_SHAPE under
    each routing of :func:`moe_case`: relative L2 within 1e-3, two
    launches a call, bit-equal reruns, CUDA-event, device and plain times,
    the bound of ``moe_experts_cost``, and as ``library_ms`` the per-expert
    cuBLAS loop (timed beside it, never called by the port); a full-width
    forward at batch 1 (seeded weights, bf16), with 56 expert and 28
    attention launches and the experts' device time a forward; then ``main
    --config dit3d_moe_xl4_res64 --mode uncond_gen`` (num_scales 10,
    beta_max 2.0, batch 1), its counts zeroed just before it. Returns
    {'launches', 'device_ms_per_forward'}."""
    import numpy as np
    import torch
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.config import get_config
    from meshdiffusion_tpu_torch.models import create_model
    from meshdiffusion_tpu_torch.ops.roofline import PEAK_BF16_FLOPS, bound_ms
    N, E, k, D, F = MOE_SHAPE
    cost = ops.moe_experts_cost(N * k, D, F, E)
    bnd, by = bound_ms(sum(c[0] for c in cost.values()), sum(c[1] for c in cost.values()),
                       PEAK_BF16_FLOPS)
    with torch.inference_mode():
        for routing in ('cell', 'skewed', 'empty'):
            x, w_gu, w_down, order, offsets, wts, _ = moe_case(dev, g, routing)
            counts = torch.diff(offsets).tolist()
            n0 = ops.moe_experts.launches
            y = ops.moe_experts(x, w_gu, w_down, order, offsets, wts, k)
            assert ops.moe_experts.launches == n0 + 2
            y2 = ops.moe_experts(x, w_gu, w_down, order, offsets, wts, k)
            ref = ops.moe_experts_reference(x, w_gu, w_down, order, offsets, wts, k)
            rel = _rel_l2(y, ref)
            err = float((y - ref).abs().max())
            assert torch.isfinite(y).all() and torch.equal(y, y2) and rel <= 1e-3, (routing, rel)
            del y2, ref
            call = lambda: ops.moe_experts(x, w_gu, w_down, order, offsets, wts, k)  # noqa: E731
            ms = _time_ms(call, 20)
            dms = _kernel_ms(call, 'moe_experts', per_call=2)[0]
            pms = _time_ms(lambda: ops.moe_experts_reference(x, w_gu, w_down, order, offsets,
                                                             wts, k), 3, 1)
            bounds = offsets.tolist()
            lms = _time_ms(lambda: moe_cublas_loop(x, w_gu, w_down, order, bounds, wts, k), 20)
            if routing == 'cell':      # the cell's routing: the kernels line's row
                record('moe_experts', err, ms, pms, bnd, by, lms)
            per_shape.append({'name': 'moe_experts', 'routing': routing, 'rows': N * k,
                              'experts': E, 'D': D, 'F': F, 'counts': counts, 'rel_l2': rel,
                              'ms': ms, 'device_ms': dms, 'plain_ms': pms, 'library_ms': lms,
                              'bound_ms': bnd, 'bound_by': by})
            share = '' if dms is None else f', {100 * bnd / dms:.0f} % reached'
            print(f'moe_experts {N * k} rows over {E} experts ({routing}: {counts}), D {D}, '
                  f'F {F}: rel_l2 {rel:.3e} (bound 1e-3) max_abs_err {err:.3e}; call {ms:.4f} '
                  f'ms (CUDA events), device {_ms(dms)} ms; plain {pms:.2f} ms; per-expert '
                  f'cuBLAS loop {lms:.4f} ms; bound {bnd:.4f} ms ({by}{share})')
            del x, w_gu, w_down, order, offsets, wts, y

    cfg = get_config('dit3d_moe_xl4_res64')
    R = cfg.data.image_size
    model = create_model(cfg, dev).eval()       # outside inference mode: its weights keep versions
    with torch.inference_mode():
        with torch.no_grad():
            for prm in model.parameters():
                prm.uniform_(-0.03, 0.03, generator=g)
        x = torch.randn((1, R, R, R, 4), device=dev, generator=g)
        lab, msk = torch.tensor([500.0], device=dev), torch.ones((1, R, R, R, 1), device=dev)
        model(x, lab, msk)
        ops.reset_launch_counts()
        model(x, lab, msk)
        torch.cuda.synchronize()
        per_fwd = ops.launch_counts()
        assert per_fwd == _launches(dit_attention=28, moe_experts=56), per_fwd
        fwd_dms = _kernel_ms(lambda: model(x, lab, msk), 'moe_experts', per_call=56,
                             iters=3)[0]
        print(f'DiT-MoE-XL/4 full-width forward, batch 1, bf16: launches {per_fwd}; the expert '
              f'kernels {_ms(fwd_dms)} ms of device time a forward')
        del model, x
    gc.collect()
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix='chip_smoke_ditmoe_')
    try:
        ops.reset_launch_counts()
        npy = port_main(['--config', 'dit3d_moe_xl4_res64', '--mode', 'uncond_gen',
                         '--device', 'cuda', f'--config.model.num_scales={DIT_STEPS + 1}',
                         '--config.model.beta_max=2.0', '--config.eval.batch_size=1',
                         f'--config.eval.eval_dir={tmp}'])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        assert launches == _launches(ancestral_update=DIT_STEPS, dit_attention=28 * DIT_STEPS,
                                     moe_experts=56 * DIT_STEPS), launches
        sample = np.load(npy)
        assert sample.shape == (1, 4, R, R, R) and np.isfinite(sample).all()
        print(f'main --config dit3d_moe_xl4_res64 --mode uncond_gen: {DIT_STEPS} steps; '
              f'launches {launches}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {'launches': launches, 'device_ms_per_forward': fwd_dms}


FLUX_SHAPE = (4, 512, 4096, 24)     # phase 24d: batch, txt tokens, img tokens, heads of 128


def flux_qk_inputs(dev, g, single: bool, shape=FLUX_SHAPE):
    """``ops.qk_norm_rope``'s arguments at ``shape`` (B, T1, T2, H), heads
    of 128, as the FLUX blocks give them, drawn from ``g``: two 3 D wide
    sources (txt, img) with their own scales, or one 7 D wide source
    (``linear1``'s output); scales in [0.5, 1.5]; a rotation table of
    angles drawn uniform."""
    import torch
    B, T1, T2, H = shape
    D, dh = H * 128, 128

    def src(T, width):
        return (torch.randn((B, T, width), device=dev, generator=g) * 2).to(torch.bfloat16)
    scales = [0.5 + torch.rand(dh, device=dev, generator=g) for _ in range(4)]
    ang = torch.rand((T1 + T2, dh // 2), device=dev, generator=g) * 6.3
    pe = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1).contiguous()
    if single:
        return (src(T1 + T2, 7 * D), scales[0], scales[1], pe, H)
    return (src(T1, 3 * D), scales[0], scales[1], pe, H, src(T2, 3 * D), scales[2], scales[3])


def flux_run(port_main, dev, g, record, per_shape) -> dict:
    """Phase 24d: the FLUX.1 preset (``flux3d_dev_res64``). Its two kernels
    at the cell's shapes (FLUX_SHAPE: 4 x 4608 joint tokens, 24 heads of
    128): the dh-128 attention against the plain version (relative L2
    within 1e-2 per head) with ``F.scaled_dot_product_attention`` on the
    same q, k, v timed beside it as ``library_ms`` (never called by the
    port); ``qk_norm_rope`` in both modes against its plain version (v bit
    for bit, q and k within one bf16 rounding); for each CUDA-event, device
    and plain times, the bound and the share of it reached. Then a
    full-width forward at batch 4 (seeded weights, bf16), whose 30 blocks
    launch each kernel 30 times, with each kernel's device time a forward;
    then ``main --config flux3d_dev_res64 --mode uncond_gen`` (num_scales
    10, beta_max 2.0, batch 1), its counts zeroed just before it. Returns
    {'launches', 'attn_device_ms_per_forward', 'qkrope_device_ms_per_forward'}."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.config import get_config
    from meshdiffusion_tpu_torch.models import create_model
    from meshdiffusion_tpu_torch.ops.roofline import PEAK_BF16_FLOPS, bound_ms
    B, T1, T2, H = FLUX_SHAPE
    T, dh = T1 + T2, 128
    D = H * dh
    with torch.inference_mode():
        qkv = torch.randn((B, T, 3 * D), device=dev, generator=g).to(torch.bfloat16)
        n0 = ops.dit_attention.launches
        y = ops.dit_attention(qkv, H)
        assert ops.dit_attention.launches == n0 + 1
        r = torch.cat([ops.dit_attention_reference(qkv[b:b + 1].float(), H) for b in range(B)])
        yh, rh = y.float().reshape(B, T, H, dh), r.reshape(B, T, H, dh)
        rel = float(((yh - rh).norm(dim=(1, 3)) / rh.norm(dim=(1, 3))).max())
        err = float((yh - rh).abs().max())
        assert torch.isfinite(y).all() and rel <= 1e-2, rel
        del r, yh, rh, y
        call = lambda: ops.dit_attention(qkv, H)  # noqa: E731
        ms = _time_ms(call, 20)
        dms = _kernel_ms(call, 'dit_attention')[0]
        pms = _time_ms(lambda: ops.dit_attention_reference(qkv, H), 3, 1)
        q, k, v = qkv.reshape(B, T, 3, H, dh).permute(2, 0, 3, 1, 4)
        lms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
        ldms = _device_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        ldms = sum(ldms.values()) or None
        bnd, by = bound_ms(*ops.dit_attention_cost(B, T, H, dh), PEAK_BF16_FLOPS)
        record('dit_attention', err, ms, pms, bnd, by, lms)
        share = None if dms is None else 100 * bnd / dms
        per_shape.append({'name': 'dit_attention', 'qkv': list(qkv.shape), 'heads': H,
                          'rel_l2': rel, 'ms': ms, 'device_ms': dms, 'plain_ms': pms,
                          'library_ms': lms, 'library_device_ms': ldms, 'bound_ms': bnd,
                          'bound_by': by, 'share_of_bound': share,
                          'kv_bytes': ops.dit_attention_kv_bytes(B, T, H, dh)})
        print(f'dit_attention qkv{tuple(qkv.shape)} {H} heads of {dh}: rel_l2 {rel:.3e} '
              f'(bound 1e-2 a head) max_abs_err {err:.3e}; call {ms:.4f} ms (CUDA events), '
              f'device {_ms(dms)} ms; plain {pms:.2f} ms; scaled_dot_product_attention '
              f'{lms:.4f} ms (device {_ms(ldms)} ms); bound {bnd:.4f} ms ({by}'
              f'{"" if share is None else f", {share:.1f} % reached"})')
        del qkv, q, k, v

        bnd, by = bound_ms(*ops.qk_norm_rope_cost(B, T, H, dh))
        for single in (False, True):
            args = flux_qk_inputs(dev, g, single, FLUX_SHAPE)
            n0 = ops.qk_norm_rope.launches
            y = ops.qk_norm_rope(*args)
            assert ops.qk_norm_rope.launches == n0 + 1
            assert torch.equal(y, ops.qk_norm_rope(*args))
            fargs = [a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
                     else a for a in args]
            ref = ops.qk_norm_rope_reference(*fargs)
            v_src = (args[0][..., 2 * D:3 * D] if single else
                     torch.cat([args[0][..., 2 * D:], args[5][..., 2 * D:]], dim=1))
            assert torch.equal(y[..., 2 * D:], v_src)
            torch.testing.assert_close(y[..., :2 * D].float(), ref[..., :2 * D],
                                       rtol=2 ** -8, atol=1e-5)
            rel = _rel_l2(y[..., :2 * D], ref[..., :2 * D])
            err = float((y[..., :2 * D].float() - ref[..., :2 * D]).abs().max())
            del y, ref, fargs, v_src
            call = lambda: ops.qk_norm_rope(*args)  # noqa: E731
            ms = _time_ms(call, 50)
            dms = _kernel_ms(call, 'qk_norm_rope')[0]
            pms = _time_ms(lambda: ops.qk_norm_rope_reference(*args), 5, 1)
            mode = 'single' if single else 'double'
            record('qk_norm_rope', err, ms, pms, bnd, by)
            share = None if dms is None else 100 * bnd / dms
            per_shape.append({'name': 'qk_norm_rope', 'mode': mode,
                              'sources': [list(a.shape) for a in args
                                          if isinstance(a, torch.Tensor) and a.ndim == 3],
                              'heads': H, 'rel_l2': rel, 'ms': ms, 'device_ms': dms,
                              'plain_ms': pms, 'library_ms': None, 'bound_ms': bnd,
                              'bound_by': by, 'share_of_bound': share})
            print(f'qk_norm_rope {mode} ({B}, {T1} + {T2}, {H} heads of {dh}): q, k rel_l2 '
                  f'{rel:.3e} max_abs_err {err:.3e} (one bf16 rounding), v bit-equal; call '
                  f'{ms:.4f} ms (CUDA events), device {_ms(dms)} ms; plain {pms:.3f} ms; bound '
                  f'{bnd:.4f} ms ({by}{"" if share is None else f", {share:.1f} % reached"})')
            del args

    cfg = get_config('flux3d_dev_res64')
    R, m = cfg.data.image_size, cfg.model
    blocks = m.depth + m.depth_single_blocks
    model = create_model(cfg, dev).eval()       # outside inference mode: its weights keep versions
    with torch.inference_mode():
        with torch.no_grad():
            for name, prm in model.named_parameters():
                if name.endswith('.scale'):
                    prm.uniform_(0.5, 1.5, generator=g)
                else:
                    prm.uniform_(-0.02, 0.02, generator=g)
        x = torch.randn((B, R, R, R, 4), device=dev, generator=g)
        cond = dict(txt=torch.randn((B, m.context_len, m.context_in_dim), device=dev,
                                    generator=g),
                    y=torch.randn((B, m.vec_in_dim), device=dev, generator=g),
                    guidance=torch.full((B,), float(m.guidance), device=dev))
        lab = torch.full((B,), 500.0, device=dev)
        msk = torch.ones((1, R, R, R, 1), device=dev)
        fwd = lambda: model(x, lab, msk, **cond)  # noqa: E731
        fwd()
        ops.reset_launch_counts()
        fwd()
        torch.cuda.synchronize()
        per_fwd = ops.launch_counts()
        assert per_fwd == _launches(dit_attention=blocks, qk_norm_rope=blocks), per_fwd
        attn_dms = _kernel_ms(fwd, 'dit_attention', per_call=blocks, iters=3)[0]
        qk_dms = _kernel_ms(fwd, 'qk_norm_rope', per_call=blocks, iters=3)[0]
        fwd_ms = _time_ms(fwd, 3, 1)
        print(f'FLUX full-width forward ({m.depth} double + {m.depth_single_blocks} single '
              f'blocks), batch {B}, bf16: {fwd_ms:.2f} ms (CUDA events); launches {per_fwd}; '
              f'the attention kernel {_ms(attn_dms)} ms and the QK norm and RoPE kernel '
              f'{_ms(qk_dms)} ms of device time a forward')
        del model, x, cond, fwd
    gc.collect()
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix='chip_smoke_flux_')
    try:
        ops.reset_launch_counts()
        npy = port_main(['--config', 'flux3d_dev_res64', '--mode', 'uncond_gen',
                         '--device', 'cuda', f'--config.model.num_scales={DIT_STEPS + 1}',
                         '--config.model.beta_max=2.0', '--config.eval.batch_size=1',
                         f'--config.eval.eval_dir={tmp}'])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        assert launches == _launches(ancestral_update=DIT_STEPS,
                                     dit_attention=blocks * DIT_STEPS,
                                     qk_norm_rope=blocks * DIT_STEPS), launches
        sample = np.load(npy)
        assert sample.shape == (1, 4, R, R, R) and np.isfinite(sample).all()
        print(f'main --config flux3d_dev_res64 --mode uncond_gen: {DIT_STEPS} steps; '
              f'launches {launches}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {'launches': launches, 'attn_device_ms_per_forward': attn_dms,
            'qkrope_device_ms_per_forward': qk_dms}


FIT_ITERS, FIT_POOL = 10, 4     # phase 7: iterations a pass, GT view batches


def fit_run(entry, rec, gt_path: str, out_dir: str):
    """One ``main --mode fit_dmtets`` run through ``entry`` on the GT mesh,
    FIT_ITERS iterations a pass and a pool of FIT_POOL GT view batches:
    (written, peak device memory above what was held before it, the passes'
    log records)."""
    import torch
    cfg_path = out_dir + '.json'
    with open(cfg_path, 'w') as f:
        json.dump({'target_pool': FIT_POOL, 'log_interval': 1}, f)
    rec.fit_passes.clear()
    rec.fit_losses.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    written = entry(['--mode', 'fit_dmtets', '--meta_path', gt_path, '--out_dir', out_dir,
                     '--fit_config', cfg_path, '--iter', str(FIT_ITERS), '--device', 'cuda'])
    torch.cuda.synchronize()
    return written, torch.cuda.max_memory_allocated() - base, list(rec.fit_passes)


def show_fit(who: str, passes, peak: int) -> None:
    for pi, n_it, n_run, pass_s, pool_s in passes:
        print(f'{who}fit pass {pi + 1}: {n_it} iterations, {n_run} steps run (capacity '
              f'redos included), {pass_s:.3f} s, {pass_s / n_run:.3f} s per step run'
              + (f' (GT pool of {min(FIT_POOL, n_it)} view batches built in {pool_s:.3f} s, inside)'
                 if pi == 0 else ''))
    print(f'{who}fit peak device memory {peak / 2 ** 30:.3f} GiB above what was held '
          f'before it')


SV_ITERS = 20              # phase 8: single-view iterations (the GT bootstrap every 10)
COND_STEPS, FREEZE = 10, 8  # phase 10: cond_gen's num_scales and freeze_iters


def singleview_run(entry, gt_path: str, out_dir: str):
    """One ``main --mode fit_singleview`` run through ``entry`` on the GT
    mesh at FitConfig's defaults, SV_ITERS iterations: (the dict's path,
    peak device memory above what was held before it, the inputs and
    outputs of every one-layer z-test call (the visibility render's))."""
    import torch
    from meshdiffusion_tpu_torch.render import rasterize as raster
    cfg_path = out_dir + '.json'
    with open(cfg_path, 'w') as f:
        json.dump({'log_interval': 10}, f)
    one_layer, launch = [], raster.tile_zmin

    def recording(*args):
        out = launch(*args)
        if args[6] == 1:
            one_layer.append((args, out))
        return out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    raster.tile_zmin = recording
    try:
        path = entry(['--mode', 'fit_singleview', '--meta_path', gt_path, '--out_dir', out_dir,
                      '--fit_config', cfg_path, '--iter', str(SV_ITERS), '--device', 'cuda'])
    finally:
        raster.tile_zmin = launch
    torch.cuda.synchronize()
    return path, torch.cuda.max_memory_allocated() - base, one_layer


TRAIN_MICRO, TRAIN_ITER, TRAIN_STEPS = 12, 4, 3   # phase 12: micro-batch, iter_size, n_iters
TRAIN_GRIDS, TRAIN_PATHS = 16, 48                 # synthetic grids, meta-list entries


def train_data(out_dir: str, mask, n_grids: int = TRAIN_GRIDS,
               n_paths: int = TRAIN_PATHS) -> list:
    """``n_grids`` synthetic (4, R, R, R) fp32 grids in the reference's file
    layout: the SDF channel the sign of a noisy ball of random radius, the
    deforms normal(0, 0.1) zeroed outside the tet grid's ``mask``; and
    ``meta.json``, a list of ``n_paths`` of their paths (each grid in turn).
    Returns the grid paths."""
    import numpy as np
    rng = np.random.default_rng(0)
    R = mask.shape[0]
    c = (np.arange(R, dtype=np.float32) - (R - 1) / 2) / R
    dist = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
    paths = []
    for i in range(n_grids):
        g = np.empty((4, R, R, R), np.float32)
        g[0] = np.sign(rng.uniform(0.15, 0.4) - dist + 0.02 * rng.standard_normal(dist.shape))
        g[1:] = 0.1 * rng.standard_normal((3, R, R, R)).astype(np.float32) * mask
        paths.append(os.path.join(out_dir, f'grid_{i:05d}.npy'))
        np.save(paths[-1], g)
    with open(os.path.join(out_dir, 'meta.json'), 'w') as f:
        json.dump([paths[i % n_grids] for i in range(n_paths)], f)
    return paths


def train_run(entry, meta: str, out_dir: str):
    """One ``main --mode train`` run through ``entry``: the res64 preset,
    micro-batch TRAIN_MICRO x iter_size TRAIN_ITER, steps 0..TRAIN_STEPS,
    logged at step 0 and at the last (``log_freq`` TRAIN_STEPS), so the
    trainer's own log times steps 1..TRAIN_STEPS as it runs them, the host
    waiting for the card at the last only; the preemption snapshot at the
    last step. Wrapping ``losses.make_train_step`` records each step's
    device span (CUDA events around it, no synchronisation) and its loss:
    (the final TrainState, [per step {step, ms: the device span, loss,
    unchanged: weights equal to those before (step 0 only)}], the weights
    before step 0, peak device memory of the run)."""
    import torch
    from meshdiffusion_tpu_torch.diffusion import losses
    steps, make, first = [], losses.make_train_step, []

    def timed_make(*args, **kw):
        step_fn = make(*args, **kw)

        def timed(state, batch, source=None):
            if state.step == 0:
                first.extend(p.detach().clone() for p in state.model.parameters())
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = step_fn(state, batch, source)
            ev[1].record()
            rec = {'step': state.step - 1, 'ev': ev, 'loss': out['loss'].detach(),
                   'unchanged': None}
            if rec['step'] == 0:    # the warm step, outside the timed window: it may wait
                rec['unchanged'] = all(torch.equal(p, q)
                                       for p, q in zip(state.model.parameters(), first))
            steps.append(rec)
            return out
        return timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses.make_train_step = timed_make
    try:
        state = entry(['--config', 'res64', '--mode', 'train', '--device', 'cuda',
                       f'--config.data.meta_path={meta}', '--config.data.num_workers=8',
                       f'--config.training.batch_size={TRAIN_MICRO}',
                       f'--config.training.iter_size={TRAIN_ITER}',
                       f'--config.training.n_iters={TRAIN_STEPS}',
                       f'--config.training.log_freq={TRAIN_STEPS}',
                       f'--config.training.snapshot_freq_for_preemption={TRAIN_STEPS}',
                       f'--config.training.train_dir={out_dir}'])
    finally:
        losses.make_train_step = make
    torch.cuda.synchronize()
    for rec in steps:
        t0, t1 = rec.pop('ev')
        rec['ms'], rec['loss'] = t0.elapsed_time(t1), float(rec['loss'])
    return state, steps, first, torch.cuda.max_memory_allocated()


# kernel family of a profiled training step -> substrings of its kernels' names (the first hit)
_TRAIN_FAMILIES = (
    ('K3 gn_silu_conv3d', ('gn_silu_conv3d_kernel', 'splitk_reduce_kernel')),
    ('gn_stats', ('gn_stats_kernel',)),
    ('cuDNN conv dgrad', ('dgrad',)),
    ('cuDNN conv wgrad', ('wgrad',)),
    ('cuDNN conv forward', ('fprop',)),
    ('cuDNN other (layouts, conv)', ('cudnn', 'conv', 'implicit')),
    ('matmul', ('gemm', 'gemv', 'cutlass', 'cublas')),
    ('Adam + EMA (foreach)', ('multi_tensor_apply', 'foreach', 'lerp')),
)


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in _TRAIN_FAMILIES:
        if any(k in low for k in keys):
            return fam
    return 'elementwise and other'


# ---- phases 13-18: the data tools, res128 generation, the likelihood ----

R128, B128 = 128, 7        # res128: grid resolution, the preset's eval.batch_size
R128_STEPS = 9             # phase 16: uncond_gen steps (num_scales 10)
LIKELIHOOD_T = (1e-3, 0.5, 1.0)   # phase 18: drift and divergence times
GRID_FIELDS = ('verts', 'indices', 'unique_edges', 'tet_edge_to_unique', 'vert_grid_coords')


def data_tools_run(dict_path: str, work: str, dev):
    """Phase 13: ``data.convert`` on a fitted dict (tets-to-3dgrid on the
    card, get-tet-mask, save-meta) and the port's dataset reading the
    result: (the grid's path, the dataset's (R, R, R, 4) sample, seconds
    of the conversion)."""
    import numpy as np
    import torch
    from meshdiffusion_tpu_torch.data.convert import main as convert_main
    from meshdiffusion_tpu_torch.data.dataset import ShapeNetDMTetDataset
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    src = os.path.join(work, 'tets')
    os.makedirs(src)
    shutil.copy(dict_path, os.path.join(src, 'dmt_dict_00000' + os.path.splitext(dict_path)[1]))
    t0 = time.perf_counter()
    grids = convert_main(['tets-to-3dgrid', '-res', '64', '-s', src, '-t',
                          os.path.join(work, 'grids'), '--device', str(dev)])
    convert_s = time.perf_counter() - t0
    mask_path = convert_main(['get-tet-mask', '--resolution', '64', '--out',
                              os.path.join(work, 'mask.npy')])
    meta = convert_main(['save-meta', '--data-dir', os.path.join(work, 'grids'), '--out',
                         os.path.join(work, 'meta.json')])
    assert len(grids) == 1 and json.load(open(meta)) == grids, (grids, meta)
    tg = TetGrid.load(64)
    mask = np.load(mask_path)
    assert mask.dtype == np.float32 and np.array_equal(mask, tg.grid_mask())
    grid = np.load(grids[0])
    assert grid.shape == (4, 64, 64, 64) and grid.dtype == np.float32
    d = torch.load(dict_path, map_location=dev, weights_only=True)
    sdf, deform = tg.grid_to_tet(torch.as_tensor(np.moveaxis(grid, 0, -1), device=dev))
    s = torch.sign(d['sdf'].float())
    assert torch.equal(sdf, torch.where(s == 0, torch.ones_like(s), s)), 'sdf sign'
    assert torch.equal(deform, d['deform'].float().clamp(-1.0, 1.0)), 'clipped deform'
    sample = ShapeNetDMTetDataset(meta, mask)[0]
    assert sample.shape == (64, 64, 64, 4) and np.isfinite(sample).all()
    assert set(np.unique(sample[..., 0]).tolist()) <= {-1.0, 1.0}
    return grids[0], sample, convert_s


def grid128_run() -> dict:
    """Phase 14: the 128 tet grid generated with its cache removed, then
    read back from the cache: seconds, V / T / E, the mask's ones."""
    import numpy as np
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid, cache_path
    cache = cache_path(R128)
    if os.path.exists(cache):
        os.remove(cache)
    TetGrid.load.cache_clear()
    t0 = time.perf_counter()
    made = TetGrid.load(R128)
    gen_s = time.perf_counter() - t0
    assert os.path.exists(cache), cache
    TetGrid.load.cache_clear()
    t0 = time.perf_counter()
    tg = TetGrid.load(R128)
    read_s = time.perf_counter() - t0
    for k in GRID_FIELDS:
        assert np.array_equal(getattr(made, k), getattr(tg, k)), k
    n = R128 - 1
    out = {'generate_s': gen_s, 'read_s': read_s, 'cache_bytes': os.path.getsize(cache),
           'V': tg.num_verts, 'T': tg.num_tets, 'E': tg.num_edges,
           'mask_ones': int(tg.grid_mask().sum())}
    assert (out['V'], out['T'], out['E'], out['mask_ones']) == \
        (n ** 3, 6 * (n - 1) ** 3, 3 * n * n * (n - 1) + 3 * n * (n - 1) ** 2 + (n - 1) ** 3,
         n ** 3), out
    print(f'128 tet grid: generated (Kuhn lattice, edges deduplicated, parity) in {gen_s:.2f} s '
          f'(host), cached ({out["cache_bytes"] / 2 ** 20:.0f} MiB), read back in {read_s:.2f} s; '
          f'V {out["V"]}, T {out["T"]}, E {out["E"]}; grid_mask() has {out["mask_ones"]} ones')
    return out


def _seeded(cfg, dev, g):
    """The full-width model with seeded normal(0, 0.02) weights, in eval
    mode; its plain comparisons run it within ``ops.plain()``."""
    import torch
    from meshdiffusion_tpu_torch.models import create_model
    model = create_model(cfg, dev)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=g)
    return model.eval()


def _plain_per_sample_ms(ref, check, batch: int) -> float:
    """The plain version on a batch one sample at a time: ``ref(s)`` for
    each sample s between its own pair of CUDA events, ``check(s, out)``
    after the second; the summed ms of the ``ref`` windows, the checks left
    out."""
    import torch
    evs = []
    for s in range(batch):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = ref(s)
        ev[1].record()
        evs.append(ev)
        check(s, out)
        del out
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs)


def res128_kernels_run(dev, g, record, per_shape) -> dict:
    """Phase 15: every kernel at the res128 preset's shapes. K3 and the
    statistics at each distinct conv shape of a batch-1 forward (as phase
    3); at batch 7, the level-0 conv shapes (up to 3.76e9 elements, past
    2^31), the ancestral update and the output head, each sample held
    against the plain version of that sample; the full-width forward at
    batch 1 against plain; then one batch-7 forward, kernels only: launches,
    time, device time by kernel, peak memory."""
    import numpy as np
    import torch
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.config import get_config
    from meshdiffusion_tpu_torch.diffusion.sampling import StepTables
    from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    from meshdiffusion_tpu_torch.ops import _build
    from meshdiffusion_tpu_torch.ops.gn_silu_conv import _plan, gn_silu_conv3d_bound_ms
    from meshdiffusion_tpu_torch.ops.roofline import bound_ms
    cfg = get_config('res128')
    assert cfg.eval.batch_size == B128, cfg.eval.batch_size
    R = R128
    mask = torch.as_tensor(TetGrid.load(R).grid_mask(), device=dev)[None, ..., None]
    model_k = _seeded(cfg, dev, g)
    x1 = torch.randn((1, R, R, R, 4), device=dev, generator=g)
    lab1 = torch.full((1,), 500.0, device=dev)
    conv_calls, head = capture_conv_shapes(model_k, x1, lab1, mask)
    n_conv = sum(conv_calls.values())
    assert n_conv == 64, n_conv
    print(f'res128 path: {n_conv} gn_silu_conv3d calls a forward at {len(conv_calls)} distinct '
          f'shapes (batch 1); output head GroupNorm+SiLU at {head["shape"]} {head["dtype"]}')
    first = len(per_shape)
    conv_shape_checks(conv_calls, dev, g, record, per_shape)
    nin_shape_checks(conv_calls, dev, g, record, per_shape)
    k3 = [r for r in per_shape[first:] if r['name'] == 'gn_silu_conv3d']
    slower = [(r['x'], r['dtype'], r['O']) for r in k3 if r['ms'] >= r['plain_ms']]
    print(f'res128 K3 at batch 1: slower than plain (CUDA events) at {slower or "no shape"}')

    out = {'conv_shapes_batch1': len(conv_calls), 'batch7': []}
    with torch.inference_mode():
        # the level-0 conv shapes at batch 7, each sample against plain
        for xs1, xdt, O in sorted((k for k in conv_calls if k[0][1] == R), key=str):
            xs = (B128,) + xs1[1:]
            C = xs[-1]
            xc = torch.randn(xs, device=dev, generator=g).add_(0.3).to(xdt)
            sc = 1.0 + 0.1 * torch.randn(C, device=dev, generator=g)
            bi = 0.1 * torch.randn(C, device=dev, generator=g)
            kern = (torch.randn((3, 3, 3, C, O), device=dev, generator=g)
                    / (27 * C) ** 0.5).to(torch.bfloat16)
            packed = ops.pack_conv_weights(kern)
            cb = 0.1 * torch.randn(O, device=dev, generator=g)
            call = lambda: ops.gn_silu_conv3d(xc, sc, bi, kern, cb, packed=packed)
            route = _plan(*xs, O, _build.sm_count(dev.index or 0)).route
            d0 = ops.gn_silu_conv3d.descriptor_launches
            y = call()
            assert ops.gn_silu_conv3d.descriptor_launches - d0 == route, (xs, O, route)
            a, b = ops.gn_affine(xc, sc, bi)
            rels, errs = [], [0.0, 0.0]

            def k3_check(s, r):
                rels.append(_rel_l2(y[s:s + 1], r))
                errs[0] = max(errs[0], float((y[s:s + 1].float() - r.float()).abs().max()))

            def stats_check(s, r):
                ra, rb = r
                torch.testing.assert_close(a[s:s + 1], ra, rtol=1e-5, atol=1e-5)
                torch.testing.assert_close(b[s:s + 1], rb, rtol=1e-5, atol=1e-5)
                errs[1] = max(errs[1], float((a[s:s + 1] - ra).abs().max()),
                              float((b[s:s + 1] - rb).abs().max()))

            # the plain versions a sample at a time (the whole batch would not fit
            # beside it), each sample's comparison outside its timed window
            pms = _plain_per_sample_ms(
                lambda s: ops.gn_silu_conv3d_reference(xc[s:s + 1], sc, bi, kern, cb),
                k3_check, B128)
            s_pms = _plain_per_sample_ms(
                lambda s: ops.gn_affine_reference(xc[s:s + 1], sc, bi), stats_check, B128)
            err, err_s = errs
            assert torch.isfinite(y).all() and max(rels) <= 1e-2, (xs, xdt, O, rels)
            ms = _time_ms(call, 3, 1)
            dms = _kernel_ms(call, 'gn_silu_conv3d', iters=3)[0]
            dstats = _kernel_ms(call, 'gn_affine', iters=3)[0]
            bnd, by = gn_silu_conv3d_bound_ms(xs, xdt, O)
            record('gn_silu_conv3d', err, ms, pms, bnd, by)
            s_bnd, s_by = bound_ms(*ops.gn_affine_cost(xs, xdt))
            s_ms = _time_ms(lambda: ops.gn_affine(xc, sc, bi), 3, 1)
            s_lms, s_ldms = _var_mean_ms(xc)
            record('gn_affine', err_s, s_ms, s_pms, s_bnd, s_by, s_lms, s_ldms)
            row = {'name': 'gn_silu_conv3d', 'x': list(xs), 'dtype': str(xdt)[6:], 'O': O,
                   'route': ('registers', 'descriptor')[route],
                   'ms': ms, 'device_ms': dms, 'stats_device_ms': dstats,
                   'plain_ms_per_sample_loop': pms, 'bound_ms': bnd, 'bound_by': by,
                   'rel_l2_per_sample': rels, 'stats_max_abs_err': err_s, 'stats_ms': s_ms,
                   'stats_plain_ms_per_sample_loop': s_pms, 'stats_bound_ms': s_bnd,
                   'var_mean_ms': s_lms,
                   'var_mean_device_ms': s_ldms, 'elements': int(np.prod(xs))}
            per_shape.append(row)
            out['batch7'].append(row)
            print(f'K3 gn_silu_conv3d x{xs} {str(xdt)[6:]} -> O={O} (A by {row["route"]}; '
                  f'{row["elements"]:.3e} '
                  f'elements): each sample against plain, rel_l2 max {max(rels):.3e} (bound '
                  f'1e-2), statistics max_abs_err {err_s:.3e} (bound 1e-5); call {ms:.3f} ms, '
                  f'device {_ms(dms)} ms (+ stats {_ms(dstats)}), bound {bnd:.3f} ms ({by}, '
                  f'{100 * bnd / ms:.0f} % of it by CUDA events); plain a sample at a time '
                  f'{pms:.3f} ms; '
                  f'statistics alone {s_ms:.3f} ms (bound {s_bnd:.3f}), torch.var_mean '
                  f'{s_lms:.3f} ms')
            del xc, y, a, b, packed
            torch.cuda.empty_cache()

        # the ancestral update at (7, R, R, R, 4)
        tables = StepTables.build(VPSDE(N=cfg.model.num_scales))
        shape = (B128, R, R, R, 4)
        x, e, nz = (torch.randn(shape, device=dev, generator=g) for _ in range(3))
        err = 0.0
        for i in (0, 500, 998):
            beta, std = float(tables.beta[i]), float(tables.std[i])
            kx, km = ops.ancestral_update(x, e, mask, nz, beta, std)
            px, pm = ops.ancestral_update_reference(x, e, mask, nz, beta, std)
            torch.testing.assert_close(kx, px, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(km, pm, rtol=1e-5, atol=1e-5)
            err = max(err, float((kx - px).abs().max()), float((km - pm).abs().max()))
        ms = _time_ms(lambda: ops.ancestral_update(x, e, mask, nz, beta, std), 20)
        pms = _time_ms(lambda: ops.ancestral_update_reference(x, e, mask, nz, beta, std), 20)
        dms = _kernel_ms(lambda: ops.ancestral_update(x, e, mask, nz, beta, std),
                         'ancestral_update')[0]
        bnd, by = bound_ms(*ops.ancestral_update_cost(shape, mask.shape))
        record('ancestral_update', err, ms, pms, bnd, by)
        out['ancestral_update'] = {'x': list(shape), 'ms': ms, 'device_ms': dms, 'plain_ms': pms,
                                   'bound_ms': bnd, 'max_abs_err': err}
        print(f'K1 ancestral_update {shape} f32: max_abs_err {err:.3e} (bound 1e-5) kernel '
              f'{ms:.4f} ms, device {_ms(dms)} ms, plain {pms:.4f} ms, bound {bnd:.4f} ms ({by})')
        del x, e, nz, kx, km, px, pm

        # the output head at batch 7: statistics and apply, each sample against plain
        hs = (B128,) + tuple(head['shape'][1:])
        C = hs[-1]
        xg = (torch.randn(hs, device=dev, generator=g).mul_(2.0).add_(0.5)).to(head['dtype'])
        sc = 1.0 + 0.1 * torch.randn(C, device=dev, generator=g)
        bi = 0.1 * torch.randn(C, device=dev, generator=g)
        y = ops.groupnorm_silu(xg, sc, bi)
        errs = [0.0]

        def head_check(s, r):
            torch.testing.assert_close(y[s:s + 1], r, rtol=1e-5, atol=1e-5)
            errs[0] = max(errs[0], float((y[s:s + 1] - r).abs().max()))

        pms = _plain_per_sample_ms(lambda s: ops.groupnorm_silu_reference(xg[s:s + 1], sc, bi),
                                   head_check, B128)
        err = errs[0]
        ms = _time_ms(lambda: ops.groupnorm_silu(xg, sc, bi), 3, 1)
        head_call = lambda: ops.groupnorm_silu(xg, sc, bi)
        bnd, by = bound_ms(*ops.groupnorm_silu_cost(hs, head['dtype']))
        record('groupnorm_silu', err, ms, pms, bnd, by)
        out['head'] = {'x': list(hs), 'dtype': str(head['dtype'])[6:], 'ms': ms,
                       'plain_ms_per_sample_loop': pms,
                       'apply_device_ms': _kernel_ms(head_call, 'groupnorm_silu', iters=3)[0],
                       'stats_device_ms': _kernel_ms(head_call, 'gn_affine', iters=3)[0],
                       'bound_ms': bnd,
                       'max_abs_err': err}
        print(f'K2 groupnorm_silu (stats + apply) {hs} {str(head["dtype"])[6:]} '
              f'({int(np.prod(hs)):.3e} elements): each sample against plain, max_abs_err '
              f'{err:.3e} (bound 1e-5); call {ms:.3f} ms, device apply '
              f'{_ms(out["head"]["apply_device_ms"])} + statistics '
              f'{_ms(out["head"]["stats_device_ms"])} ms; bound {bnd:.3f} ms ({by})')
        del xg, y
        torch.cuda.empty_cache()

        # the full-width forward at batch 1, kernels against plain
        ops.reset_launch_counts()
        y_k = model_k(x1, lab1, mask)
        torch.cuda.synchronize()
        per_fwd = ops.launch_counts()
        desc_fwd = ops.gn_silu_conv3d.descriptor_launches
        with ops.plain():
            y_p = model_k(x1, lab1, mask)
        rel = _rel_l2(y_k, y_p)
        assert torch.isfinite(y_k).all() and y_k.shape == x1.shape and rel <= 1e-2, rel
        assert per_fwd == _launches(gn_affine=65, groupnorm_silu=1, gn_silu_conv3d=64,
                                    nin_residual=20), per_fwd
        assert desc_fwd == 20, desc_fwd          # the O = 128 convs at 128^3 and 64^3
        print(f'res128 full-width forward, batch 1, bf16: rel_l2 kernels vs plain {rel:.3e} '
              f'(bound 1e-2); launches a forward {per_fwd}, {desc_fwd} of K3\'s on the '
              f'descriptor route')
        del y_k, y_p
        torch.cuda.empty_cache()

        # one full-width forward at batch 7, kernels only
        x7 = torch.randn((B128, R, R, R, 4), device=dev, generator=g)
        lab7 = torch.linspace(0.0, 999.0, B128, device=dev)
        fwd = lambda: model_k(x7, lab7, mask)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        y7 = fwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches7 = ops.launch_counts()
        assert launches7 == per_fwd, launches7
        assert torch.isfinite(y7).all() and y7.shape == x7.shape
        del y7
        ms7 = _time_ms(fwd, 2, 0)
        busy, by_kernel, seen = _window_ms(fwd, per_fwd)
        prof = _device_ms(fwd, 1)
    out.update({'forward_batch7_ms': ms7, 'forward_batch7_device_ms': busy,
                'forward_batch7_device_ms_by_kernel': by_kernel,
                'forward_batch7_launches_recorded': seen,
                'forward_batch7_peak_bytes': peak, 'held_before_bytes': base,
                'launches_per_forward': per_fwd, 'forward_batch1_rel_l2': rel})
    print(f'res128 full-width forward, batch 7, bf16, kernels: {ms7:.2f} ms (CUDA events), '
          f'device {_ms(busy)} ms (' + ', '.join(f'{n} {_ms(t)}' for n, t in by_kernel.items()
                                                 if per_fwd[n])
          + f'; the profiler recorded {seen} launches of {per_fwd}); peak device memory '
          f'{peak / 2 ** 30:.2f} GiB ({base / 2 ** 30:.2f} GiB held before: weights and their '
          f'bf16 layouts)')
    for k, t in sorted(prof.items(), key=lambda kv: -kv[1])[:12]:
        print(f'  {t:8.3f} ms  {k[:100]}')
    del model_k
    torch.cuda.empty_cache()
    return out


def uncond128_run(entry, rec, work: str, mask, dev) -> dict:
    """Phase 16: ``main --config res128 --mode uncond_gen`` at the preset's
    batch 7 (num_scales R128_STEPS + 1, beta_max 2.0), every counter set to
    0 just before and read just after; then ``main --mode extract
    --resolution 128 --no_remesh`` of its first sample: marching tets'
    seconds and the extraction's peak device memory."""
    import numpy as np
    import torch
    from meshdiffusion_tpu_torch import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    npy = entry(['--config', 'res128', '--mode', 'uncond_gen', '--device', str(dev),
                 f'--config.model.num_scales={R128_STEPS + 1}', '--config.model.beta_max=2.0',
                 f'--config.eval.eval_dir={work}'])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak_gen = torch.cuda.max_memory_allocated()
    n = R128_STEPS
    assert launches == _launches(ancestral_update=n, gn_affine=65 * n, groupnorm_silu=n,
                                 gn_silu_conv3d=64 * n, nin_residual=20 * n), launches
    assert rec.fields['steps'] == n
    sample_s = rec.fields['sample_s']
    sample = np.load(npy)
    assert sample.shape == (B128, 4, R128, R128, R128) and np.isfinite(sample).all()
    assert not (sample * (1 - mask)).any(), 'res128 sample is non-zero outside the grid mask'
    assert all(np.abs(sample[b] * mask).max() > 0 for b in range(B128))
    one = os.path.join(work, 'first.npy')
    np.save(one, sample[:1])
    del sample
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    objs = entry(['--mode', 'extract', '--sample_path', one, '--out_dir',
                  os.path.join(work, 'meshes'), '--resolution', str(R128), '--no_remesh',
                  '--device', str(dev)])
    extract_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak_ex = torch.cuda.max_memory_allocated()
    nv, nf = rec.fields['mesh_size']
    with open(objs[0]) as f:
        assert f.read(2) == 'v '
    assert nf > 0 and os.path.getsize(objs[0]) > 0
    out = {'steps': n, 'batch': B128, 'sample_s': sample_s, 'ms_per_step': 1000 * sample_s / n,
           'launches': launches, 'peak_bytes': peak_gen,
           'extract': {'marching_s': rec.fields['marching_s'],
                       'postprocess_s': rec.fields['postprocess_s'], 'command_s': extract_s,
                       'verts': nv, 'faces': nf, 'obj_bytes': os.path.getsize(objs[0]),
                       'peak_bytes': peak_ex, 'held_before_bytes': held}}
    print(f'uncond_gen res128: batch {B128}, {n} steps in {sample_s:.3f} s, '
          f'{out["ms_per_step"]:.2f} ms a step ({out["ms_per_step"] / B128:.2f} a sample); peak '
          f'device memory {peak_gen / 2 ** 30:.2f} GiB; launches {launches}')
    print(f'extract res128 (sample 0, no remesh): {nv} verts, {nf} faces; marching tets '
          f'{out["extract"]["marching_s"]:.3f} s (AoS tables on the card), smooth '
          f'{out["extract"]["postprocess_s"]:.3f} s, command {extract_s:.3f} s (.obj '
          f'{out["extract"]["obj_bytes"] / 2 ** 20:.0f} MiB); peak device memory '
          f'{peak_ex / 2 ** 30:.2f} GiB ({held / 2 ** 30:.2f} GiB held before)')
    return out


def viz128_run(entry, rec, work: str, record, dev) -> dict:
    """Phase 17: a real shape on the 128 grid (the GT SDF's sign at its
    vertices, deform 0) scattered by ``data.convert.tets_to_grid`` on the
    card, then ``main --mode extract --resolution 128 --save_viz`` with the
    full post-process, counters set to 0 just before and read just after:
    tile_zmin once, its call held bit-equal against its plain version."""
    import numpy as np
    import torch
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.data.convert import tets_to_grid
    from meshdiffusion_tpu_torch.geometry.obj_io import read_obj
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    from meshdiffusion_tpu_torch.render import rasterize as raster
    from meshdiffusion_tpu_torch.render.utils import decode_png
    os.makedirs(work, exist_ok=True)
    tg = TetGrid.load(R128)
    sdf = np.where(gt_sdf(tg.verts) >= 0, 1.0, -1.0).astype(np.float32)
    grid = tets_to_grid(tg, sdf, np.zeros((tg.num_verts, 3), np.float32), device=dev)
    assert grid.shape == (4, R128, R128, R128)
    gt_npy = os.path.join(work, 'gt128.npy')
    np.save(gt_npy, grid[None])
    calls, launch = [], raster.tile_zmin

    def recording(*args):
        out = launch(*args)
        calls.append((args, out))
        return out
    ops.reset_launch_counts()
    raster.tile_zmin = recording
    try:
        t0 = time.perf_counter()
        objs = entry(['--mode', 'extract', '--sample_path', gt_npy, '--out_dir',
                      os.path.join(work, 'gt'), '--resolution', str(R128), '--save_viz',
                      '--device', str(dev)])
        command_s = time.perf_counter() - t0
    finally:
        raster.tile_zmin = launch
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    renders = rec.fields['viz_renders']     # 1, and 1 more a capacity regrowth
    assert not any(rec.fields['viz_overflow'].values()), rec.fields['viz_overflow']
    assert launches == _launches(tile_zmin=renders) and len(calls) == renders, \
        (launches, renders, len(calls))
    v, f = read_obj(objs[0])
    assert len(f) > 1000 and np.isfinite(v).all(), len(f)
    png = os.path.join(work, 'gt', 'viz', 'viz_000000.png')
    with open(png, 'rb') as fh:
        pix = decode_png(fh.read())
    assert pix.shape == (512, 512, 3) and pix.std() > 5.0, (pix.shape, pix.std())
    zargs, (kt, kz) = calls[-1]          # the render the PNG shows
    with torch.inference_mode():
        pt, pz = ops.tile_zmin_reference(*zargs)
        assert torch.equal(kt, pt) and torch.equal(kz, pz) and int((pt >= 0).sum()) > 1000
        call = lambda: ops.tile_zmin(*zargs)
        ms = _time_ms(call, 20)
        dms, seen, issued = _kernel_ms(call, 'tile_zmin')
        pms = _time_ms(lambda: ops.tile_zmin_reference(*zargs), 3, 1)
        bnd, by = ops.tile_zmin_bound_ms(zargs[0], zargs[2], zargs[4], zargs[5], num_layers=1,
                                         best_z=kz)
    if dms is not None and dms > 1.05 * ms:
        dms = None
    record('tile_zmin', 0.0, ms, pms, bnd, by)
    live = zargs[2].view(zargs[4].shape[0], -1) + zargs[4][:, None]
    out = {'verts': len(v), 'faces': len(f), 'marching_s': rec.fields['marching_s'],
           'postprocess_s': rec.fields['postprocess_s'], 'command_s': command_s,
           'renders': renders, 'pixels_hit': int((pt >= 0).sum()), 'png_std': float(pix.std()),
           'launches': launches, 'tile_zmin': {'ms': ms, 'device_ms': dms, 'plain_ms': pms,
                                               'bound_ms': bnd, 'bound_by': by,
                                               'faces': zargs[0].shape[1],
                                               'pairs': int(live.sum()),
                                               'heaviest_tile': int(live.max())}}
    print(f'extract res128 --save_viz on the GT shape: {len(v)} verts, {len(f)} faces; marching '
          f'tets {out["marching_s"]:.3f} s, post-process (remesh, smooth 3, remesh) '
          f'{out["postprocess_s"]:.3f} s, command {command_s:.3f} s; viz 512^2 PNG, pixel std '
          f'{pix.std():.1f}; {renders} render(s) (the capacities grown on overflow); launches '
          f'{launches}; the last z-test (one layer, {zargs[0].shape[1]} '
          f'faces, {int(live.sum())} live pairs): ids equal and z bit-equal to plain, '
          f'{out["pixels_hit"]} pixels hit; device {_ms(dms)} ms (profiler recorded {seen} of '
          f'{issued} launches), CUDA events {ms:.4f} ms; plain {pms:.2f} ms; bound {bnd:.4f} ms '
          f'({by})')
    return out


def _eps_vjp(model_fn, x, t, eps, N):
    """eps^T (d eps_hat / dx): the U-Net's own vector-Jacobian product at
    (x, t), the network's share of the divergence estimate before the
    final sum with eps."""
    import torch
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(model_fn(x, t * (N - 1)), x, eps)
    return g


def likelihood_run(sample, dev, g) -> dict:
    """Phase 18: the likelihood on the res64 model at full width, batch 1,
    on phase 13's grid. The drift and the Hutchinson divergence at
    LIKELIHOOD_T with kernels against the plain versions (seeded normal(0,
    0.02) weights); then ``likelihood_fn`` (rtol = atol = 1e-3) from
    start to end on the seeded init the generators sample from without a
    checkpoint, whose last convs are zero-scaled: its epsilon is ~1e-5, so
    the ODE is dx/dt = -beta(t) x / 2 and bits/dim has a closed form, which
    it is held to."""
    import numpy as np
    import torch
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.config import get_config
    from meshdiffusion_tpu_torch.diffusion.likelihood import (get_drift_and_div_fn,
                                                              get_likelihood_fn,
                                                              hutchinson_noise)
    from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    from meshdiffusion_tpu_torch.models import create_model
    from meshdiffusion_tpu_torch.models.layers import ResnetBlockDDPM
    cfg = get_config('res64')
    R = cfg.data.image_size
    mask = torch.as_tensor(TetGrid.load(R).grid_mask(), device=dev)[None, ..., None]
    sde = VPSDE(beta_min=cfg.model.beta_min, beta_max=cfg.model.beta_max, N=cfg.model.num_scales)
    model_k = _seeded(cfg, dev, g).requires_grad_(False)
    n_conv = 2 * sum(isinstance(m, ResnetBlockDDPM) for m in model_k.modules())   # 74 at res64
    x = torch.as_tensor(sample[None], device=dev)
    eps = hutchinson_noise('Rademacher', dev, 0)('hutchinson', x.shape)
    fn = get_drift_and_div_fn(sde, lambda z, lab: model_k(z, lab, mask))
    fns = {'kernels': fn, 'plain': lambda *a: _plain(fn, *a)}
    rows = []
    for t in LIKELIHOOD_T:
        tt = torch.full((1,), t, device=dev)
        ops.reset_launch_counts()
        dk, vk = fns['kernels'](x, tt, eps)
        torch.cuda.synchronize()
        n = ops.launch_counts()
        assert n == _launches(gn_affine=n_conv, gn_silu_conv3d=n_conv), n
        dp, vp = fns['plain'](x, tt, eps)
        rel_d = _rel_l2(dk, dp)
        rel_v = float((vk - vp).abs() / vp.abs())
        # the network's own share, its vector-Jacobian product eps^T (d eps_hat / dx):
        # held by relative L2 as phase 12 holds gradients. (Its sum with eps, ~50-100
        # out of 1e6 terms of either sign, is ill-conditioned, and in the fp32 total the
        # linear part -beta n / 2, 1e7 at t = 1, leaves it a few ulps.)
        gk = _eps_vjp(lambda z, lab: model_k(z, lab, mask), x, tt, eps, sde.N)
        gp = _plain(_eps_vjp, lambda z, lab: model_k(z, lab, mask), x, tt, eps, sde.N)
        rel_net = _rel_l2(gk, gp)
        net_k, net_p = (float((gv.double() * eps.double()).sum()) for gv in (gk, gp))
        assert torch.isfinite(dk).all() and torch.isfinite(vk).all(), t
        assert rel_d <= 1e-2 and rel_v <= 1e-2 and rel_net <= 2e-2, (t, rel_d, rel_v, rel_net)
        ms_k = _time_ms(lambda: fns['kernels'](x, tt, eps), 3, 1)
        ms_p = _time_ms(lambda: fns['plain'](x, tt, eps), 3, 1)
        rows.append({'t': t, 'drift_rel_l2': rel_d, 'div_rel_err': rel_v, 'div': float(vk),
                     'eps_vjp_rel_l2': rel_net, 'eps_jacobian_sum': [net_k, net_p],
                     'ms_kernels': ms_k, 'ms_plain': ms_p})
        print(f'likelihood res64, t={t:g}: drift rel_l2 kernels vs plain {rel_d:.3e} (bound '
              f'1e-2), divergence {float(vk):.6e} against {float(vp):.6e} (relative error '
              f'{rel_v:.3e}, bound 1e-2); the network\'s vector-Jacobian product eps^T J rel_l2 '
              f'{rel_net:.3e} (bound 2e-2), eps^T J eps {net_k:.6e} against {net_p:.6e} (fp64 '
              f'sums); an evaluation (forward '
              f'and its vector-Jacobian product) {ms_k:.2f} ms with kernels, {ms_p:.2f} ms '
              f'plain; launches {n}')
    del model_k, fn, fns
    torch.cuda.empty_cache()

    model = create_model(cfg, dev, torch.Generator(device=dev).manual_seed(cfg.seed)).eval()
    model.requires_grad_(False)
    lk = get_likelihood_fn(sde, lambda z, lab: model(z, lab, mask), rtol=1e-3, atol=1e-3,
                           device=dev)
    data = sample[None].astype(np.float32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    bpd, z, nfe = lk(0, data)
    lk_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    assert launches == _launches(gn_affine=n_conv * nfe, gn_silu_conv3d=n_conv * nfe), \
        (launches, nfe)
    e0 = 1e-5
    integral = sde.beta_0 * (1 - e0) + (sde.beta_1 - sde.beta_0) * (1 - e0 ** 2) / 2
    n_dim = data[0].size
    z_exact = data * np.exp(-integral / 2)
    bpd_exact = ((n_dim / 2 * np.log(2 * np.pi) + (z_exact.astype(np.float64) ** 2).sum() / 2
                  + n_dim * integral / 2) / (n_dim * np.log(2)) + 8.0)
    assert z.shape == data.shape and np.isfinite(z).all() and np.isfinite(bpd).all()
    assert abs(float(bpd[0]) - bpd_exact) <= 1e-3, (bpd, bpd_exact)
    out = {'per_t': rows, 'nfe': int(nfe), 'bpd': float(bpd[0]), 'bpd_closed_form': bpd_exact,
           'seconds': lk_s, 'launches': launches}
    print(f'likelihood_fn res64 (rtol = atol = 1e-3, Rademacher, seeded init): nfe {nfe}, '
          f'bpd {float(bpd[0]):.6f} (closed form {bpd_exact:.6f}), {lk_s:.2f} s, '
          f'{1000 * lk_s / nfe:.1f} ms an evaluation; launches {launches}')
    return out


# ---- phases 19-20: the textured fit (neural material, HDR light, validation, bake) ----

TEX_ITERS, TEX_LL_ITERS, TEX_SV_ITERS = 10, 3, 10   # iterations a pass (19, 20), single view
TEX_VIEWS = 8                                       # validate_views
BAKE_RES = 1024                                     # export_baked's texture_res


def textured_gt(folder: str) -> str:
    """The textured fit's GT: the torus united with the box of
    :func:`gt_mesh`, each vertex's texture coordinates its box projection
    (the two coordinates off its normal's dominant axis), and an .mtl with
    ``bsdf diffuse``, ``map_Kd`` (a 64^2 PNG: a colour gradient with a
    checker) and ``map_Ks``, written by the port's ``write_obj``.
    Returns the .obj's path."""
    import numpy as np
    import torch
    from meshdiffusion_tpu_torch.geometry.marching_tets import compact_mesh, marching_tets
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    from meshdiffusion_tpu_torch.render import mesh as mesh_mod
    from meshdiffusion_tpu_torch.render import obj as obj_mod
    from meshdiffusion_tpu_torch.render.material import Material
    from meshdiffusion_tpu_torch.render.texture import Texture2D
    grid = TetGrid.load(64)
    v, f = compact_mesh(marching_tets(grid, torch.from_numpy(grid.verts),
                                      torch.from_numpy(gt_sdf(grid.verts))))
    m = mesh_mod.auto_normals(mesh_mod.Mesh(v_pos=torch.as_tensor(v, dtype=torch.float32),
                                            t_pos_idx=torch.as_tensor(f, dtype=torch.int64)))
    axis = m.v_nrm.abs().argmax(dim=1)
    keep = torch.tensor([[1, 2], [0, 2], [0, 1]])[axis]            # the two other axes
    uv = torch.gather(m.v_pos, 1, keep) * 0.5 + 0.5
    y, x = np.mgrid[0:64, 0:64] / 63.0
    kd = np.stack([0.2 + 0.7 * x, 0.3 + 0.5 * y, 0.8 - 0.6 * x * y], -1)
    kd *= np.where(((np.mgrid[0:64, 0:64] // 8).sum(0) % 2) == 0, 1.0, 0.6)[..., None]
    m = mesh_mod.Mesh.combine(m, v_tex=uv, t_tex_idx=m.t_pos_idx)
    m.material = Material({'name': 'gt', 'bsdf': 'diffuse', 'kd': Texture2D(kd.astype(np.float32)),
                           'ks': Texture2D(np.zeros((8, 8, 3), np.float32) + [0.0, 0.3, 0.0])})
    return obj_mod.write_obj(folder, m, save_material=True)


def sky_hdr(path: str, h: int = 256, w: int = 512) -> None:
    """A latlong sky as a flat-scanline Radiance .hdr: a blue zenith over a
    warm horizon, a dark ground, and a small sun ~50x the sky's radiance."""
    import numpy as np
    theta = (np.arange(h) + 0.5) / h * np.pi                        # 0 at the zenith
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi
    up = np.cos(theta)[:, None, None]
    sky = np.where(up > 0, np.array([0.35, 0.55, 1.0]) * (0.4 + 0.6 * up)
                   + np.array([0.9, 0.7, 0.5]) * (1 - up) ** 4, np.array([0.15, 0.12, 0.1]))
    sky = np.broadcast_to(sky, (h, w, 3)).copy()
    ang = np.arccos(np.clip(np.sin(theta)[:, None] * np.sin(0.6) * np.cos(phi[None] - 1.0)
                            + np.cos(theta)[:, None] * np.cos(0.6), -1, 1))
    sky[ang < 0.05] = (60.0, 55.0, 45.0)
    m = sky.max(-1)
    mant, expo = np.frexp(m)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.floor(sky * (mant * 256.0 / m)[..., None]).astype(np.uint8)
    rgbe[..., 3] = (expo + 128).astype(np.uint8)
    with open(path, 'wb') as f:
        f.write(b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n' + f'-Y {h} +X {w}\n'.encode()
                + rgbe.tobytes())


# kernel family of a profiled fit step -> substrings of its kernels' names (the first hit)
_FIT_FAMILIES = (
    ('tile_zmin', ('tile_zmin_kernel',)),
    ('sort (binning)', ('radixsort', 'sort')),
    ('gather / index_select (hash encode, interpolation)', ('indexselect', 'index_select',
                                                           'gather')),
    ('scatter / index_add (their backward)', ('indexfunc', 'index_add', 'scatter',
                                              'index_put', 'put_kernel')),
    ('matmul (MLP, light)', ('gemm', 'gemv', 'cutlass', 'cublas', 'xmma')),
    ('Adam (foreach)', ('multi_tensor_apply', 'foreach')),
    ('reduction', ('reduce',)),
    ('scan (cumsum)', ('scan',)),
)


def _fit_family(name: str) -> str:
    low = name.lower()
    for fam, keys in _FIT_FAMILIES:
        if any(k in low for k in keys):
            return fam
    return 'elementwise and other'


def textured_fit_run(entry, rec, gt_path: str, out_dir: str, cfg: dict, iters: int, dev,
                     profile_iter=None):
    """One ``main --mode fit_dmtets`` run of the textured GT with the fit
    config ``cfg`` (target_pool FIT_POOL), counters set to 0 just before
    and read just after. It records every tile_zmin call (the fit's
    renders, the validation renders, the bake's), the
    neural material the fit builds (its start kept), and with
    ``profile_iter`` profiles pass 1's step at that iteration (device ms a
    kernel). Returns a dict of what it saw; of the tile_zmin calls, each
    one's (res, layers, views), and whole (arguments, result) the first fit
    step's render and the last bake render."""
    import torch
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.fitting import fit as fit_mod
    from meshdiffusion_tpu_torch.render import rasterize as raster
    cfg_path = out_dir + '.json'
    with open(cfg_path, 'w') as f:
        json.dump({'target_pool': FIT_POOL, 'log_interval': 1, **cfg}, f)
    calls, kept, mats, prof = [], {}, [], {}
    launch, make_mat, make_step = raster.tile_zmin, fit_mod.make_mlp_material, fit_mod.make_fit_step

    def recording(*args):
        out = launch(*args)
        calls.append((tuple(args[5]), args[6], args[0].shape[0]))
        # kept whole: the first fit step's render (after the GT pool's) and the last bake's
        if args[6] == 2 and sum(c[1] == 2 for c in calls) == FIT_POOL + 1:
            kept['fit'] = (args, out)
        if tuple(args[5]) == (BAKE_RES, BAKE_RES):
            kept['bake'] = (args, out)
        return out

    def material(*a, **k):
        m = make_mat(*a, **k)
        mats.append((m, {n: p.detach().clone() for n, p in m.named_parameters()}))
        return m

    def stepper(fitter, cfg_, renderer, pass_idx=0, *a, **k):
        step = make_step(fitter, cfg_, renderer, pass_idx, *a, **k)
        if profile_iter is None or pass_idx != 0:
            return step

        def profiled(state, light_base, opt_geo, opt_lgt, target, iteration, *rest):
            if iteration != profile_iter or prof:
                return step(state, light_base, opt_geo, opt_lgt, target, iteration, *rest)
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as p:
                out = step(state, light_base, opt_geo, opt_lgt, target, iteration, *rest)
                torch.cuda.synchronize()
            for e in p.key_averages():
                if _dev_us(e):
                    prof[e.key] = prof.get(e.key, 0.0) + _dev_us(e) / 1000.0
            return out
        return profiled

    rec.fit_passes.clear()
    rec.fit_losses.clear()
    rec.fields.pop('validate', None)
    rec.fields.pop('parametrize', None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    raster.tile_zmin, fit_mod.make_mlp_material, fit_mod.make_fit_step = \
        recording, material, stepper
    try:
        t0 = time.perf_counter()
        written = entry(['--mode', 'fit_dmtets', '--meta_path', gt_path, '--out_dir', out_dir,
                         '--fit_config', cfg_path, '--iter', str(iters), '--device', str(dev)])
        command_s = time.perf_counter() - t0
    finally:
        raster.tile_zmin, fit_mod.make_mlp_material, fit_mod.make_fit_step = \
            launch, make_mat, make_step
    torch.cuda.synchronize()
    return {'written': written, 'iters': iters, 'launches': ops.launch_counts(), 'calls': calls,
            'kept': kept,
            'mats': mats,
            'prof': prof, 'peak': torch.cuda.max_memory_allocated() - base,
            'passes': list(rec.fit_passes), 'losses': list(rec.fit_losses),
            'validate': rec.fields.get('validate'), 'parametrize': rec.fields.get('parametrize'),
            'command_s': command_s}


def check_textured_fit(run: dict, out_dir: str, cfg: dict, V: int, dev) -> dict:
    """The checks of a textured fit run: both dicts with the JAX package's
    keys, shapes and finite values, every loss finite, every parameter of
    the neural material moved, tile_zmin launched once a render and its
    calls by kind (fit renders: 2 layers; the bake's: 1 view, 1 layer at
    BAKE_RES^2; validation: 1 view, 1 layer at display_res), metrics.txt
    with its rows, and the baked .obj read back with a non-uniform kd.
    Returns the counts."""
    import numpy as np
    import torch
    from meshdiffusion_tpu_torch.render import obj as obj_mod
    assert len(run['written']) == 1 and len(run['passes']) == 2, (run['written'], run['passes'])
    w = run['written'][0]
    pre, fin = (torch.load(w[k]) for k in ('tets_pre', 'tets'))
    assert set(pre) == {'sdf', 'sdf_ema', 'deform', 'deform_unmasked'}, set(pre)
    assert set(fin) == {'sdf', 'deform', 'deform_unmasked'}, set(fin)
    for d in (pre, fin):
        assert d['sdf'].shape == (V,) and d['deform'].shape == (V, 3)
        assert all(torch.isfinite(t).all() for t in d.values())
    assert set(fin['sdf'].unique().tolist()) <= {-1.0, 1.0}
    losses = [loss for _, _, loss in run['losses']]
    assert losses and all(np.isfinite(losses)), run['losses']
    assert len(run['mats']) == 1
    mat, start = run['mats'][0]
    moved = {n: float((p.detach() - start[n]).abs().max()) for n, p in mat.named_parameters()}
    assert set(moved) == {'encoder.table', 'dense_0.weight', 'dense_1.weight', 'dense_2.weight'}
    assert all(m > 0 for m in moved.values()), moved
    steps_run = sum(p[2] for p in run['passes'])
    kinds = {'fit': 0, 'validate': 0, 'bake': 0}
    for res, layers, views in run['calls']:
        kind = ('fit' if layers == 2 else None if views != 1
                else 'bake' if res == (BAKE_RES, BAKE_RES) else 'validate')
        assert kind is not None, (res, layers, views)
        kinds[kind] += 1
    n_views = cfg.get('validate_views', 8) if cfg.get('validate') else 0
    pool = min(FIT_POOL, run['iters'])
    assert kinds['fit'] == pool + steps_run and kinds['validate'] == 2 * n_views, kinds
    assert kinds['bake'] >= (1 if cfg.get('save_baked') else 0), kinds
    assert run['launches']['tile_zmin'] == len(run['calls']), (run['launches'], len(run['calls']))
    assert all(n == 0 for k, n in run['launches'].items() if k != 'tile_zmin'), run['launches']
    if n_views:
        val_dir = os.path.join(out_dir, 'val_viz', 'dmtet_validate_0')
        with open(os.path.join(val_dir, 'metrics.txt')) as f:
            rows = f.read().splitlines()
        assert rows[0] == 'ID, MSE, PSNR' and len(rows) == n_views + 2, rows
        assert rows[-1].startswith('AVERAGES') and np.isfinite(
            [[float(x) for x in r.split(',')[1:]] for r in rows[1:-1]]).all(), rows
        assert all(os.path.exists(os.path.join(val_dir, f'val_{i:06d}_{k}.png'))
                   for i in range(n_views) for k in ('opt', 'ref'))
    out = {'steps_run': steps_run, 'renders': kinds, 'moved': moved}
    if cfg.get('save_baked'):
        baked = obj_mod.load_mesh(w['baked'], device=dev)
        kd = baked.material['kd'].data
        spread = float(kd.max() - kd.min())           # at least two 8-bit levels apart
        assert kd.shape == (1, BAKE_RES, BAKE_RES, 3) and spread >= 1.5 / 255, (kd.shape, spread)
        assert baked.v_tex is not None and baked.t_tex_idx.shape == baked.t_pos_idx.shape
        for name in ('mesh.mtl', 'texture_kd.png', 'texture_ks.png', 'texture_n.png'):
            assert os.path.exists(os.path.join(os.path.dirname(w['baked']), name)), name
        out.update(baked_faces=int(baked.t_pos_idx.shape[0]), baked_kd_spread=spread)
    return out


def zmin_plain_check(call, record, name: str) -> dict:
    """One recorded tile_zmin call held bit-equal to its plain version, then
    timed (CUDA events, torch.profiler device time, plain) beside its bound."""
    import torch
    from meshdiffusion_tpu_torch import ops
    zargs, (kt, kz) = call
    layers = zargs[6]
    with torch.inference_mode():
        pt, pz = ops.tile_zmin_reference(*zargs)
        assert torch.equal(kt, pt) and torch.equal(kz, pz), name
        hits = int((pt[0] >= 0).sum())
        assert hits > 1e-3 * pt[0].numel(), (name, hits)
        fn = lambda: ops.tile_zmin(*zargs)
        ms = _time_ms(fn, 10)
        dms, seen, issued = _kernel_ms(fn, 'tile_zmin')
        pms = _time_ms(lambda: ops.tile_zmin_reference(*zargs), 2, 1)
        bnd, by = ops.tile_zmin_bound_ms(zargs[0], zargs[2], zargs[4], zargs[5],
                                         num_layers=layers, best_z=kz)
    if dms is not None and dms > 1.05 * ms:
        dms = None
    record('tile_zmin', 0.0, ms, pms, bnd, by)
    live = zargs[2].view(zargs[4].shape[0], -1) + zargs[4][:, None]
    row = {'name': 'tile_zmin', 'case': name, 'res': list(zargs[5]), 'layers': layers,
           'views': zargs[0].shape[0], 'faces': zargs[0].shape[1], 'pairs': int(live.sum()),
           'heaviest_tile': int(live.max()), 'hits': hits, 'ms': ms, 'device_ms': dms,
           'launches_recorded': [seen, issued], 'plain_ms': pms, 'bound_ms': bnd,
           'bound_by': by, 'library_ms': None}
    print(f'tile_zmin {name}: {row["views"]} view(s) at {row["res"]}, {layers} layer(s), '
          f'{row["faces"]} faces a view, {row["pairs"]} live (candidate, tile) pairs, the heaviest '
          f'tile {row["heaviest_tile"]}: ids equal and z bit-equal to plain, {hits} pixels hit; '
          f'device {_ms(dms)} ms (profiler recorded {seen} of {issued} launches), CUDA events '
          f'{ms:.4f} ms; plain {pms:.2f} ms; bound {bnd:.4f} ms ({by})')
    return row


def material_cost(mat, n: int, dev) -> dict:
    """The neural material's forward and backward (hash encode, MLP, the
    table's index_add) at ``n`` points, the size of a fit step's samples:
    CUDA-event ms and device ms by family."""
    import torch
    g = torch.Generator(device=dev).manual_seed(5)
    x = (torch.rand((n, 3), device=dev, generator=g) - 0.5) * 1.2
    up = torch.randn((n, 9), device=dev, generator=g)

    def fwd_bwd():
        mat.zero_grad(set_to_none=True)
        (mat(x) * up).sum().backward()
    ms = _time_ms(fwd_bwd, 5, 1)
    fams = {}
    for k, t in _device_ms(fwd_bwd, 3).items():
        fams[_fit_family(k)] = fams.get(_fit_family(k), 0.0) + t
    mat.zero_grad(set_to_none=True)
    return {'points': n, 'ms': ms, 'device_ms': sum(fams.values()), 'device_ms_by_family': fams}


def textured_phases(entry, rec, record, per_shape, dev) -> dict:
    """Phases 19 and 20. 19: ``main --mode fit_dmtets`` on the textured GT
    with the neural material (``normal_only`` false), the sky .hdr as the
    light (``envmap``), ``random_lgt``, ``validate`` (TEX_VIEWS views) and
    ``save_baked``, TEX_ITERS iterations a pass, pass 1's step at iteration
    TEX_ITERS // 2 profiled; the first fit step's z-test and the bake's
    (one view, one layer at BAKE_RES^2, every candidate at z = 0) held
    bit-equal to plain; the material's forward and backward at a step's
    sample count. 20: the same fit with ``learn_light`` in place of the
    .hdr, TEX_LL_ITERS iterations a pass; then ``main --mode
    fit_singleview`` under the .hdr, TEX_SV_ITERS iterations.
    Returns {'launches': by path, 'json': the numbers}."""
    import torch
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.fitting.fit import FitConfig
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    fcfg = FitConfig()
    V = TetGrid.load(fcfg.dmtet_grid, fcfg.tet_root).num_verts
    tmp = tempfile.mkdtemp(prefix='chip_smoke_tex_')
    out = {}
    try:
        gt = textured_gt(os.path.join(tmp, 'gt'))
        hdr = os.path.join(tmp, 'sky.hdr')
        sky_hdr(hdr)
        # ---- 19. the textured fit under the .hdr light ----
        cfg19 = {'normal_only': False, 'envmap': hdr, 'random_lgt': True, 'validate': True,
                 'validate_views': TEX_VIEWS, 'save_baked': True}
        run = textured_fit_run(entry, rec, gt, os.path.join(tmp, 'tex'), cfg19, TEX_ITERS, dev,
                               profile_iter=TEX_ITERS // 2)
        seen = check_textured_fit(run, os.path.join(tmp, 'tex'), cfg19, V, dev)
        rows = [zmin_plain_check(run['kept']['fit'], record, 'textured fit step render'),
                zmin_plain_check(run['kept']['bake'], record, f'UV bake {BAKE_RES}^2, z = 0')]
        per_shape.extend(rows)
        passes = [{'pass': p[0] + 1, 'iterations': p[1], 'steps_run': p[2], 's': p[3],
                   's_per_step': p[3] / p[2], 'pool_s': p[4]} for p in run['passes']]
        fams = {}
        for k, t in run['prof'].items():
            fams[_fit_family(k)] = fams.get(_fit_family(k), 0.0) + t
        H, W = fcfg.train_res
        n_pts = fcfg.batch * 2 * (H * W // 4) * 2      # views x layers x shade_cap x (jitter)
        mat_cost = material_cost(run['mats'][0][0], n_pts, dev)
        views, mse, psnr = run['validate']
        faces, verts, param_s = run['parametrize']
        show_fit('textured ', run['passes'], run['peak'])
        print(f'textured fit_dmtets (neural material, .hdr sky, random_lgt, validate, save_baked): '
              f'launches {run["launches"]} = renders {seen["renders"]}; every material leaf moved '
              f'(max |change| {seen["moved"]}); validate over {views} views: MSE {mse:.6f}, PSNR '
              f'{psnr:.3f}; bake: parametrize {faces} faces -> {verts} atlas vertices in '
              f'{param_s:.3f} s on the host, {BAKE_RES}^2 maps, kd spread {seen["baked_kd_spread"]:.4f}; '
              f'command {run["command_s"]:.2f} s')
        busy = sum(run['prof'].values())
        print(f'textured fit step (pass 1, iteration {TEX_ITERS // 2}, under torch.profiler): '
              f'device {busy:.2f} ms; device ms by family: '
              + ', '.join(f'{f} {t:.2f}' for f, t in sorted(fams.items(), key=lambda kv: -kv[1])))
        for k, t in sorted(run['prof'].items(), key=lambda kv: -kv[1])[:12]:
            print(f'  {t:8.3f} ms  {k[:100]}')
        print(f'neural material forward + backward at {n_pts} points (a step\'s samples): '
              f'{mat_cost["ms"]:.3f} ms (CUDA events), device {mat_cost["device_ms"]:.3f} ms: '
              + ', '.join(f'{f} {t:.3f}' for f, t in mat_cost['device_ms_by_family'].items()))
        out['fit_textured'] = {'passes': passes, 'peak_gib': run['peak'] / 2 ** 30,
                               'command_s': run['command_s'], 'renders': seen['renders'],
                               'step_device_ms': busy, 'step_device_ms_by_family': fams,
                               'material_fwd_bwd': mat_cost, 'validate': run['validate'],
                               'parametrize': run['parametrize'], 'zmin': rows,
                               'losses': run['losses']}
        launches = {'fit_textured': run['launches']}
        del run

        # ---- 20. learn_light in place of the .hdr; fit_singleview under the .hdr ----
        cfg20 = {**cfg19, 'envmap': None, 'learn_light': True}
        run = textured_fit_run(entry, rec, gt, os.path.join(tmp, 'tex_ll'), cfg20, TEX_LL_ITERS,
                               dev)
        seen = check_textured_fit(run, os.path.join(tmp, 'tex_ll'), cfg20, V, dev)
        show_fit('textured learn_light ', run['passes'], run['peak'])
        print(f'textured fit_dmtets with learn_light: launches {run["launches"]} = renders '
              f'{seen["renders"]}; validate PSNR {run["validate"][2]:.3f}; command '
              f'{run["command_s"]:.2f} s')
        out['fit_textured_learn_light'] = {
            'passes': [{'pass': p[0] + 1, 'steps_run': p[2], 's': p[3]} for p in run['passes']],
            'renders': seen['renders'], 'command_s': run['command_s']}
        launches['fit_textured_learn_light'] = run['launches']
        del run

        sv_dir = os.path.join(tmp, 'sv')
        with open(sv_dir + '.json', 'w') as f:
            json.dump({'envmap': hdr, 'log_interval': 5}, f)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        path = entry(['--mode', 'fit_singleview', '--meta_path', gt, '--out_dir', sv_dir,
                      '--fit_config', sv_dir + '.json', '--iter', str(TEX_SV_ITERS),
                      '--device', str(dev)])
        sv_s = time.perf_counter() - t0
        sv_launches = ops.launch_counts()
        assert sv_launches == _launches(tile_zmin=1 + TEX_SV_ITERS + 1), sv_launches
        d = torch.load(path)
        assert set(d) == {'sdf', 'deform', 'vis', 'vis_rast'} and d['sdf'].shape == (V,)
        assert 0 < float(d['vis'].sum()) < V and all(
            bool(torch.isfinite(t.float()).all()) for t in d.values())
        print(f'fit_singleview under the .hdr sky: {TEX_SV_ITERS} iterations, command '
              f'{sv_s:.2f} s; launches {sv_launches}; vis {int(d["vis"].sum())} of {V}')
        out['fit_singleview_envmap'] = {'command_s': sv_s, 'vis': float(d['vis'].sum())}
        launches['fit_singleview_envmap'] = sv_launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {'launches': launches, 'json': out}


# ---- phases 21-23: the sharded kernels' modes, data- and spatial-parallel training ----

# the wrappers that only the spatially sharded U-Net launches
SHARDED = ('gn_silu_conv3d_halo', 'gn_moments')
PAR_MICRO = 2              # phases 21-22: samples a data row a micro-batch
PAR_STEPS = 3              # phase 22: main --mode train steps 0..PAR_STEPS
R128_PAR_STEPS = 1         # phase 23: steps 0..R128_PAR_STEPS


def parallel_kernels_run(cases, dev, g, record, per_shape) -> dict:
    """Phase 21: the two modes the sharded U-Net runs, for each of ``cases``
    (name, {(x shape, dtype, O): calls} of a forward, samples, splits) at
    every distinct conv shape with that many samples, the depth split over
    each of the splits (halos (0, 1), (1, 1), (1, 0)): each slab's moments
    (``gn_moments``) against their plain version, merged and folded against
    the unsharded ``gn_affine`` (1e-6 relative); each slab's K3 halo call
    against its plain version (relative L2 1e-2, as phase 3) and the slabs
    put together against the unsharded K3; CUDA-event and device times of
    the slabs' calls against the unsharded kernels' at the same shapes, with
    the bounds."""
    import torch
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.ops.gn_silu_conv import gn_silu_conv3d_bound_ms
    from meshdiffusion_tpu_torch.ops.roofline import bound_ms
    worst = {'halo_rel': 0.0, 'cat_rel': 0.0, 'ab_err': 0.0, 'moments_err': 0.0}
    todo = [(name, xs1, xdt, O, nb, splits) for name, conv_calls, nb, splits in cases
            for xs1, xdt, O in sorted({(xs[1:], xdt, O) for xs, xdt, O in conv_calls},
                                     key=lambda s: (-s[0][0], s[0][-1], s[2], str(s[1])))]
    rows = []
    with torch.inference_mode():
        for name, xs1, xdt, O, nb, splits in todo:
            xs, C = (nb,) + xs1, xs1[-1]
            D = xs[1]
            x = (torch.randn(xs, device=dev, generator=g) + 0.3).to(xdt)
            sc = 1.0 + 0.1 * torch.randn(C, device=dev, generator=g)
            bi = 0.1 * torch.randn(C, device=dev, generator=g)
            kern = (torch.randn((3, 3, 3, C, O), device=dev, generator=g)
                    / (27 * C) ** 0.5).to(torch.bfloat16)
            packed = ops.pack_conv_weights(kern)
            cb = 0.1 * torch.randn(O, device=dev, generator=g)
            full = lambda: ops.gn_silu_conv3d(x, sc, bi, kern, cb, packed=packed)
            y_full = full()
            a_full, b_full = ops.gn_affine(x, sc, bi)
            full_ms = _time_ms(full, 5, 1)
            full_dev = _window_full(full, {'gn_silu_conv3d': 1, 'gn_affine': 1}, 5)
            for S in splits:
                d = D // S
                slabs = [x[:, s * d:(s + 1) * d].contiguous() for s in range(S)]
                halos = [(int(s > 0), int(s < S - 1)) for s in range(S)]
                haloed = [x[:, s * d - lo:(s + 1) * d + hi].contiguous()
                          for s, (lo, hi) in enumerate(halos)]
                m = torch.stack([ops.gn_moments(sl) for sl in slabs])
                m_ref = torch.stack([ops.gn_moments_reference(sl) for sl in slabs])
                # the moments as (mean, variance): M2 is a sum over up to 2^22 elements
                n_slab = slabs[0][0].numel() // 32
                mv, mv_ref = (t / torch.tensor([1.0, n_slab], device=dev) for t in (m, m_ref))
                m_err = float((mv - mv_ref).abs().max())
                assert m_err <= 1e-5, (xs, S, m_err)
                mean, m2, n = ops.merge_moments(m, n_slab)
                a, b = ops.affine_from_moments(mean, m2, n, sc, bi)
                # relative to the affine's size (a ~ 1 / std of x): fp32 sums in another order
                ab_err = max(float((a - a_full).abs().max()), float((b - b_full).abs().max())) \
                    / max(1.0, float(a_full.abs().max()), float(b_full.abs().max()))
                assert ab_err <= 1e-6, (xs, S, ab_err)
                ys, rel = [], 0.0
                for xh, halo in zip(haloed, halos):
                    ys.append(ops.gn_silu_conv3d_halo(xh, a, b, kern, cb, halo, packed=packed))
                    r = ops.gn_silu_conv3d_halo_reference(xh, a, b, kern, cb, halo)
                    rel = max(rel, _rel_l2(ys[-1], r))
                    err = float((ys[-1].float() - r.float()).abs().max())
                cat_rel = _rel_l2(torch.cat(ys, 1), y_full)
                assert rel <= 1e-2 and cat_rel <= 1e-2 and all(
                    bool(torch.isfinite(y).all()) for y in ys), (xs, S, rel, cat_rel)
                worst = {'halo_rel': max(worst['halo_rel'], rel),
                         'cat_rel': max(worst['cat_rel'], cat_rel),
                         'ab_err': max(worst['ab_err'], ab_err),
                         'moments_err': max(worst['moments_err'], m_err)}
                conv = lambda: [ops.gn_silu_conv3d_halo(xh, a, b, kern, cb, h, packed=packed)
                                for xh, h in zip(haloed, halos)]
                moments = lambda: [ops.gn_moments(sl) for sl in slabs]
                both = lambda: (moments(), conv())
                h_ms, m_ms = _time_ms(conv, 5, 1) / S, _time_ms(moments, 5, 1) / S
                dev_ms = _window_full(both, {'gn_silu_conv3d': S, 'gn_affine': S}, 5)
                h_dev = None if dev_ms['gn_silu_conv3d'] is None else dev_ms['gn_silu_conv3d'] / S
                m_dev = None if dev_ms['gn_affine'] is None else dev_ms['gn_affine'] / S
                h_pms = _time_ms(lambda: [ops.gn_silu_conv3d_halo_reference(xh, a, b, kern, cb, h)
                                          for xh, h in zip(haloed, halos)], 3, 1) / S
                m_pms = _time_ms(lambda: [ops.gn_moments_reference(sl) for sl in slabs], 3, 1) / S
                h_bnd = sum(gn_silu_conv3d_bound_ms(xh.shape, xdt, O, h)[0]
                            for xh, h in zip(haloed, halos)) / S
                h_by = gn_silu_conv3d_bound_ms(haloed[0].shape, xdt, O, halos[0])[1]
                m_bnd, m_by = bound_ms(*ops.gn_moments_cost(slabs[0].shape, xdt))
                m_lms, m_ldms = _var_mean_ms(slabs[0])
                record('gn_silu_conv3d_halo', err, h_ms, h_pms, h_bnd, h_by)
                record('gn_moments', m_err, m_ms, m_pms, m_bnd, m_by, m_lms, m_ldms)
                row = {'model': name, 'x': list(xs), 'dtype': str(xdt)[6:], 'O': O, 'spatial': S,
                       'slab': [nb, d] + list(xs[2:]), 'halo_rel_l2': rel,
                       'cat_rel_l2_vs_unsharded': cat_rel, 'ab_err': ab_err,
                       'halo_ms': h_ms, 'halo_device_ms': h_dev, 'halo_plain_ms': h_pms,
                       'halo_bound_ms': h_bnd, 'moments_ms': m_ms, 'moments_device_ms': m_dev,
                       'moments_plain_ms': m_pms, 'moments_bound_ms': m_bnd,
                       'moments_library_ms': m_lms, 'unsharded_ms': full_ms,
                       'unsharded_k3_device_ms': full_dev['gn_silu_conv3d'],
                       'unsharded_stats_device_ms': full_dev['gn_affine']}
                rows.append(row)
                per_shape.append({'name': 'sharded_modes', **row})
                share = '' if h_dev is None else f' ({100 * h_bnd / h_dev:.0f} % of bound)'
                print(f'K3 halo {name} x{xs} {str(xdt)[6:]} -> {O} over {S} slabs: rel_l2 '
                      f'{rel:.2e} (slabs together vs unsharded {cat_rel:.2e}), a/b vs gn_affine '
                      f'{ab_err:.1e}; a slab: halo {h_ms:.4f} ms, device {_ms(h_dev)}{share}, '
                      f'plain {h_pms:.3f}, bound {h_bnd:.4f}; moments {m_ms:.4f} ms, device '
                      f'{_ms(m_dev)}, bound {m_bnd:.4f}; unsharded K3 {full_ms:.4f} ms '
                      f'(device {_ms(full_dev["gn_silu_conv3d"])} + stats '
                      f'{_ms(full_dev["gn_affine"])})')
            del x, y_full, slabs, haloed, ys
    torch.cuda.empty_cache()
    return {'worst': worst, 'rows': rows}


def _train_config(spec: dict, dropout: float):
    """The preset ``spec['config']`` with ``spec['overrides']`` (``a.b=value``),
    the global micro-batch, iter_size and ``dropout``."""
    from meshdiffusion_tpu_torch.config import apply_overrides, get_config
    cfg = apply_overrides(get_config(spec['config']),
                          [o.split('=', 1) for o in spec['overrides']])
    cfg.training.batch_size, cfg.training.iter_size = spec['global_micro'], spec['iter_size']
    cfg.model.dropout = dropout
    return cfg


def _sync(dev) -> None:
    import torch
    if dev.type == 'cuda':
        torch.cuda.synchronize()


def _reset_peak(dev) -> None:
    import torch
    if dev.type == 'cuda':
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak(dev) -> int:
    import torch
    return torch.cuda.max_memory_allocated() if dev.type == 'cuda' else 0


def _step_inputs(spec: dict, dev, mesh=None):
    """The seeded full-width model (normal(0, 0.02) weights), dropout 0, its
    TrainState, the global batch of one step (iter_size x the global
    micro-batch, seeded) with its labels and noise: (state, mask, this rank's
    batch, its source); the whole batch with ``mesh`` None."""
    import torch
    from meshdiffusion_tpu_torch.diffusion import losses
    from meshdiffusion_tpu_torch.models import create_model
    from meshdiffusion_tpu_torch.parallel import shard_batch
    cfg = _train_config(spec, 0.0)
    R = cfg.data.image_size
    g = torch.Generator(device=dev).manual_seed(7)
    model = create_model(cfg, dev)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=g)
    state = losses.TrainState.create(model, cfg, torch.Generator(device=dev))
    shape = (spec['iter_size'], spec['global_micro'], R, R, R, 4)
    x = torch.randn(shape, device=dev, generator=g)
    x[..., 0] = torch.sign(x[..., 0])
    labels = torch.randint(0, cfg.model.num_scales, shape[:2], device=dev, generator=g)
    noise = torch.randn(shape, device=dev, generator=g)
    mask = torch.ones((1, R, R, R, 1), device=dev)
    if mesh is None:
        return state, mask, x, lambda j, s: (labels[j], noise[j])
    nb = spec['global_micro'] // mesh.data
    rows = slice(mesh.data_index * nb, (mesh.data_index + 1) * nb)
    batch = shard_batch(x, mesh, spatial=True, batch_dim=1).contiguous()
    return state, mask, batch, lambda j, s: (labels[j, rows], noise[j, rows])


def _flat_grads(state):
    import torch
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in state.optimizer.params])


def _reference_main(rank: int, spec: dict) -> None:
    """A process of its own running :func:`reference_step` (so that its
    memory is the card's again when it exits): its gradient to
    ``spec['dir']/ref_grad.pt``, the rest to ``ref.json``."""
    import torch
    dev = torch.device(spec['device'])
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = reference_step(spec, dev)
    torch.save(ref.pop('grad'), os.path.join(spec['dir'], 'ref_grad.pt'))
    with open(os.path.join(spec['dir'], 'ref.json'), 'w') as f:
        json.dump(ref, f)


def reference_step(spec: dict, dev) -> dict:
    """One process running the step of :func:`_step_inputs` on the whole
    batch: its gradient (fp32, on the host), loss, seconds and peak memory."""
    import torch
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.diffusion import losses
    from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
    cfg = _train_config(spec, 0.0)
    state, mask, batch, source = _step_inputs(spec, dev)
    step = losses.make_train_step(VPSDE(beta_min=cfg.model.beta_min, beta_max=cfg.model.beta_max,
                                        N=cfg.model.num_scales), mask)
    kept, opt_step = {}, state.optimizer.step

    def keep(n):
        kept['grad'] = _flat_grads(state).cpu()
        return opt_step(n)
    state.optimizer.step = keep
    _reset_peak(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = step(state, batch, source)
    _sync(dev)
    res = {'grad': kept['grad'], 'loss': float(out['loss']), 's': time.perf_counter() - t0,
           'peak': _peak(dev), 'launches': ops.launch_counts()}
    _release(state)
    del state, batch, out
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    return res


def _release(state) -> None:
    """Undo the optimizer-step wrapper (it and the bound step it wraps form
    a reference cycle that would keep the model and its Adam state alive)."""
    del state.optimizer.step


def _rank_main(rank: int, spec: dict) -> None:
    """One rank of phases 22-23, a process on ``spec['device']`` (cuda:0)
    joined to the others by gloo: the step of :func:`_step_inputs` on this rank's share (its
    all-reduced gradient written by rank 0, a digest of its weights after
    the step), then ``main --mode train`` on the mesh, the trainer's log,
    launch counts, peak memory and the gradient all-reduce's seconds kept;
    its numbers to ``spec['dir']/rank{rank}.json``."""
    import hashlib
    import torch
    import torch.distributed as dist
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.diffusion import losses
    from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
    from meshdiffusion_tpu_torch.main import main as port_main
    from meshdiffusion_tpu_torch.parallel import distributed, make_mesh
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    logging.getLogger().addHandler(logging.NullHandler())    # the records, not the log lines
    logging.getLogger().setLevel(logging.INFO)
    rec = _Records()
    logging.getLogger('meshdiffusion_tpu_torch').addHandler(rec)
    dev = torch.device(spec['device'])
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    assert distributed.maybe_initialize('gloo', f'localhost:{spec["port"]}', spec['world'], rank)
    out = {'rank': rank}
    # the gradient all-reduce's own seconds (the host waits for the card on both sides)
    ar_s, all_reduce = [], losses.all_reduce_grads

    def timed_all_reduce(params, mesh):
        _sync(dev)
        t0 = time.perf_counter()
        all_reduce(params, mesh)
        _sync(dev)
        ar_s.append(time.perf_counter() - t0)
    losses.all_reduce_grads = timed_all_reduce

    # one step on this rank's share of the global batch
    mesh = make_mesh(spec['data'], spec['spatial'])
    cfg = _train_config(spec, 0.0)
    state, mask, batch, source = _step_inputs(spec, dev, mesh)
    step = losses.make_train_step(VPSDE(beta_min=cfg.model.beta_min, beta_max=cfg.model.beta_max,
                                        N=cfg.model.num_scales), mask, mesh=mesh)
    kept, opt_step = {}, state.optimizer.step

    def keep(n):
        if rank == 0:
            kept['grad'] = _flat_grads(state).cpu()
        return opt_step(n)
    state.optimizer.step = keep
    _reset_peak(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = step(state, batch, source)
    _sync(dev)
    out['step'] = {'s': time.perf_counter() - t0, 'loss': float(res['loss']),
                   'peak': _peak(dev), 'launches': ops.launch_counts(), 'all_reduce_s': ar_s[-1]}
    digest = hashlib.sha256()
    for p in state.model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    out['digest'] = digest.hexdigest()
    if rank == 0:
        torch.save(kept['grad'], os.path.join(spec['dir'], 'grad.pt'))
    _release(state)
    del state, batch, res, kept
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()

    # main --mode train on the mesh (the preset's dropout)
    run_dir = os.path.join(spec['dir'], 'run')
    _reset_peak(dev)
    ops.reset_launch_counts()
    ar_s.clear()
    port_main(['--config', spec['config'], '--mode', 'train', '--device', spec['device'],
               f'--config.data.meta_path={spec["meta"]}',
               f'--config.data.grid_mask_path={spec["mask"]}', '--config.data.num_workers=4',
               f'--config.training.batch_size={spec["global_micro"]}',
               f'--config.training.iter_size={spec["iter_size"]}',
               f'--config.training.n_iters={spec["steps"]}',
               f'--config.training.log_freq={spec["steps"]}',
               f'--config.training.snapshot_freq_for_preemption={10 ** 6}',
               f'--config.training.train_dir={run_dir}', '--config.gpu.dist_backend=gloo',
               f'--config.gpu.mesh_data_axis={spec["data"]}',
               f'--config.gpu.mesh_spatial_axis={spec["spatial"]}']
              + [f'--config.{o}' for o in spec['overrides']])
    _sync(dev)
    out['train'] = {'logs': rec.train_logs, 'launches': ops.launch_counts(),
                    'peak': _peak(dev), 'all_reduce_s': list(ar_s)}
    with open(os.path.join(spec['dir'], f'rank{rank}.json'), 'w') as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _spawn(target, args: tuple, n: int, timeout_s: float) -> None:
    """``n`` processes of ``target(rank, *args)`` (torch.multiprocessing,
    spawn; the parent has built the kernels, so none builds); the first to
    fail, or the time limit, kills them all and raises."""
    import torch.multiprocessing as mp
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=target, args=(r,) + args) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if bad or time.time() > deadline:
                raise RuntimeError(f'ranks {bad} failed (exit codes '
                                   f'{[p.exitcode for p in procs]}) or the time limit passed')
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * len(procs), codes


def spawn_ranks(spec: dict, timeout_s: float) -> list:
    """``spec['world']`` ranks of :func:`_rank_main` on this card: their
    numbers by rank."""
    spec = dict(spec, port=_free_port())
    _spawn(_rank_main, (spec,), spec['world'], timeout_s)
    out = []
    for r in range(spec['world']):
        with open(os.path.join(spec['dir'], f'rank{r}.json')) as f:
            out.append(json.load(f))
    return out


def _nccl_rank(rank: int, port: int, out: str) -> None:
    """Two ranks on cuda:0 under the nccl backend: the trainer's device check
    (``distributed.check_devices``) must raise; what it did to ``out.{rank}``."""
    import torch
    import torch.distributed as dist
    from meshdiffusion_tpu_torch.parallel import distributed
    torch.cuda.set_device(0)
    distributed.maybe_initialize('nccl', f'localhost:{port}', 2, rank)
    try:
        distributed.check_devices(torch.device('cuda', 0))
        msg = 'did not raise'
    except RuntimeError as e:      # the error this check is for, kept for the parent to read
        msg = f'raised: {e}'
    with open(f'{out}.{rank}', 'w') as f:
        f.write(msg)
    dist.destroy_process_group()


def nccl_shared_card_check(tmp: str) -> str:
    """NCCL with two ranks on one card raises, and nothing falls back to
    another backend: both ranks' messages, each 'raised: ...'."""
    out = os.path.join(tmp, 'nccl')
    _spawn(_nccl_rank, (_free_port(), out), 2, 120)
    msgs = []
    for r in range(2):
        with open(f'{out}.{r}') as f:
            msgs.append(f.read())
    assert all(m.startswith('raised: NCCL with several ranks on one card') for m in msgs), msgs
    return msgs[0]


def parallel_train_run(spec: dict, dev, timeout_s: float) -> dict:
    """Phases 22 and 23: one process's step (:func:`reference_step`), then
    the ranks (:func:`spawn_ranks`): rank 0's all-reduced gradient against
    the one process's (relative L2 1e-2, bf16), every rank's weights
    bit-equal after the step, and ``main --mode train`` on the mesh with its
    s/step, launches a rank and peak memory."""
    import numpy as np
    import torch
    from meshdiffusion_tpu_torch.models import get_model
    from meshdiffusion_tpu_torch.models.layers import ResnetBlockDDPM
    cfg = _train_config(spec, 0.0)
    with torch.device('meta'):
        blocks = sum(isinstance(m, ResnetBlockDDPM)
                     for m in get_model(cfg.model.name).from_config(cfg).modules())
    rank_dev = torch.device('cuda', dev.index or 0) if dev.type == 'cuda' else dev
    spec = dict(spec, device=str(rank_dev))
    _spawn(_reference_main, (spec,), 1, timeout_s)
    with open(os.path.join(spec['dir'], 'ref.json')) as f:
        ref = json.load(f)
    ranks = spawn_ranks(spec, timeout_s)
    grad = torch.load(os.path.join(spec['dir'], 'grad.pt'))
    rel = _rel_l2(grad, torch.load(os.path.join(spec['dir'], 'ref_grad.pt')))
    digests = {r['digest'] for r in ranks}
    assert rel <= 1e-2 and np.isfinite(ranks[0]['step']['loss']), (rel, ranks[0]['step'])
    assert len(digests) == 1, 'the ranks\' weights differ after the step'
    loss_rel = abs(ranks[0]['step']['loss'] - ref['loss']) / abs(ref['loss'])
    micro = (spec['steps'] + 1) * spec['iter_size']
    for r in ranks:
        logs = r['train']['logs']
        assert [lg[0] for lg in logs] == [0, spec['steps']] and \
            all(np.isfinite(lg[1]) for lg in logs), logs
        # chain 0 of every block through K3's halo mode, forward and remat
        # recompute (chain 1 runs plain under dropout); both chains at dropout 0
        n, n1 = r['train']['launches'], r['step']['launches']
        assert n['gn_silu_conv3d'] == n['gn_affine'] == n1['gn_silu_conv3d'] == 0, (n, n1)
        assert n['gn_silu_conv3d_halo'] == 2 * blocks * micro and n['gn_moments'] > 0, n
        assert n1['gn_silu_conv3d_halo'] == 4 * blocks * spec['iter_size'], n1
    logs = ranks[0]['train']['logs']
    launches = {k: sum(r['train']['launches'][k] for r in ranks)
                for k in ranks[0]['train']['launches']}
    return {'grad_rel_l2': rel, 'loss': ranks[0]['step']['loss'], 'loss_ref': ref['loss'],
            'loss_rel_err': loss_rel, 'ref_step_s': ref['s'], 'ref_peak': ref['peak'],
            'step_s': [r['step']['s'] for r in ranks],
            'step_peak': [r['step']['peak'] for r in ranks],
            'step_launches_rank0': ranks[0]['step']['launches'],
            'step_all_reduce_s': [r['step']['all_reduce_s'] for r in ranks],
            'warm_step_s': logs[0][2], 's_per_step': logs[-1][2] / logs[-1][3],
            'train_peak': [r['train']['peak'] for r in ranks],
            'train_all_reduce_s': [r['train']['all_reduce_s'] for r in ranks],
            'launches_rank0_per_micro': {k: v / micro for k, v in
                                         ranks[0]['train']['launches'].items()},
            'launches': launches, 'card': _smi()}


# ---- phase 24: the edge-AA alternates at full width, the fit-quality gate ----

AA_IMPLS = ('compact', 'flat', 'vmap')      # MESHDIFFUSION_AA_IMPL's values
GATE_ITERS, ABL_ITERS = 120, 150            # the gate's pass-1 iterations; the ablation's
GATE_SEEDS = (1, 2, 3, 4)                   # the gate's draws: seeds of the device's generator
# the JAX package's AA ablation (AA_ABLATION.md: 150 iterations at 64^2, JAX on the
# CPU): (chamfer, 4-pose validation PSNR dB) with AA on and off; a comparison only
JAX_ABLATION = {'on': (0.01323, 33.31), 'off': (0.01284, 29.82)}


class aa_impl:
    """``MESHDIFFUSION_AA_IMPL`` set to ``impl`` inside the block, restored
    after it."""

    def __init__(self, impl: str):
        self.impl = impl

    def __enter__(self):
        self.old = os.environ.get('MESHDIFFUSION_AA_IMPL')
        os.environ['MESHDIFFUSION_AA_IMPL'] = self.impl

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop('MESHDIFFUSION_AA_IMPL', None)
        else:
            os.environ['MESHDIFFUSION_AA_IMPL'] = self.old


def tiny_tet_grid():
    """The tests' tiny tet grid (tests/conftest.py ``tiny_tet_grid``) as the
    port's TetGrid: an 8^3 vertex lattice over [-0.45, 0.45]^3, each cube
    cut into the 6 Kuhn tets."""
    import numpy as np
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    n = 8
    xs = np.linspace(-0.45, 0.45, n, dtype=np.float32)
    verts = np.stack(np.meshgrid(xs, xs, xs, indexing='ij'), -1).reshape(-1, 3)
    vid = np.arange(n ** 3).reshape(n, n, n)
    corner = [vid[i:n - 1 + i, j:n - 1 + j, k:n - 1 + k].reshape(-1)
              for k in (0, 1) for j in (0, 1) for i in (0, 1)]
    kuhn = ((0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7), (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7))
    tets = np.stack([np.stack([corner[a] for a in t], 1) for t in kuhn], 1).reshape(-1, 4)
    return TetGrid.from_arrays(n, verts, tets.astype(np.int32))


def _gate_reference(tg, work: str, dev):
    """The gate's GT: the sphere of radius 0.3 marched on ``tg``, written
    as an .obj and read back, centred, with normals and the default
    material; and its constant light (bias 0.5), as the JAX gate builds
    them."""
    import torch
    from meshdiffusion_tpu_torch.fitting import fit as F
    from meshdiffusion_tpu_torch.geometry.marching_tets import compact_mesh, marching_tets
    from meshdiffusion_tpu_torch.geometry.obj_io import write_obj
    from meshdiffusion_tpu_torch.render import light as light_mod
    from meshdiffusion_tpu_torch.render import mesh as mesh_mod
    from meshdiffusion_tpu_torch.render import obj as obj_mod
    import numpy as np
    path = os.path.join(work, 'gt_sphere.obj')
    sdf = np.linalg.norm(tg.verts, axis=1).astype(np.float32) - 0.3
    v, f = compact_mesh(marching_tets(tg, torch.from_numpy(tg.verts), torch.from_numpy(sdf)))
    write_obj(path, v, f)
    ref = obj_mod.load_mesh(path, device=dev)
    ref = mesh_mod.auto_normals(mesh_mod.center_by_reference(ref, mesh_mod.aabb(ref.v_pos), 1.0))
    ref.material = F.default_material(dev)
    env = light_mod.create_trainable_env_rnd(64, scale=0.0, bias=0.5, device=dev)
    env.build_mips()
    return ref, env


def _gate_draws(fitter, dev, seed: int):
    """The gate's random stream and initial state, from ``dev``'s own
    generator seeded ``seed``, as ``fitting/fit.py`` draws them. Returns
    (generator, uniform source, the fitter's initial state)."""
    import torch
    from meshdiffusion_tpu_torch.geometry.fit_losses import torch_uniform
    gen = torch.Generator(dev).manual_seed(seed)
    return gen, torch_uniform(gen, dev), fitter.init_state(gen, dev)


def _chamfer_to(fitter, state, gt_pts, uniform) -> float:
    """The chamfer distance of 2000 samples of the fitted mesh to ``gt_pts``."""
    import torch
    from meshdiffusion_tpu_torch.geometry.fit_losses import chamfer_distance, sample_points
    m = fitter.get_mesh(state)
    with torch.no_grad():
        pts = sample_points(m.v_pos, m.t_pos_idx, 2000, uniform, face_mask=m.face_mask)
        return float(chamfer_distance(pts, gt_pts))


def fit_gate(tg, work: str, dev, seed: int, iters: int = GATE_ITERS) -> dict:
    """One run of the fit-quality gate (tests/test_fit_convergence.py
    ``test_pass1_fit_converges``) on the port, under the current
    MESHDIFFUSION_AA_IMPL, from the draws of ``seed`` (:func:`_gate_draws`;
    JAX's gate draws from one key): ``iters`` pass-1 iterations of the radius-0.3
    sphere on ``tg`` at 48^2, batch 1, ``learn_light`` (the candidate's
    light a second Adam's leaf), GT views from a pool of 8. A step whose
    counters report an overflow is redone from its snapshot with the
    capacity grown, as the fit driver does (raster_K, raster_Kg,
    raster_live, shade_cap and aa_budget). Returns the numbers
    :func:`gate_failures` checks."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from meshdiffusion_tpu_torch.fitting import fit as F
    from meshdiffusion_tpu_torch.fitting.dataset import TargetRenderer
    from meshdiffusion_tpu_torch.fitting.geometry import DMTetFitter
    from meshdiffusion_tpu_torch.geometry.fit_losses import sample_points
    from meshdiffusion_tpu_torch.render.rasterize import grow_capacity
    ref, env = _gate_reference(tg, work, dev)
    res = (48, 48)
    cfg = F.FitConfig(iter=iters, batch=1, train_res=res, dmtet_grid=tg.resolution,
                      mesh_scale=1.0, surface_samples=2000, raster_K=256, normal_only=True,
                      learn_light=True, cam_radius=2.0)
    fitter = DMTetFitter(grid=tg, scale=cfg.mesh_scale, deform_scale=2.0, sdf_regularizer=0.2,
                         total_iter=cfg.iter, buffer_capacity=50)
    gen, uniform, state = _gate_draws(fitter, dev, seed)
    renderer = TargetRenderer(ref_mesh=ref, envlight=env, cam_radius=2.0, train_res=res,
                              num_surface_samples=2000, target_pool=8, generator=gen)
    state = state.replace(sdf=state.sdf.requires_grad_(), deform=state.deform.requires_grad_())
    opt_geo = torch.optim.Adam([state.sdf, state.deform], lr=0.0)
    light_base = env.base.detach().clone().requires_grad_()
    light_base0 = light_base.detach().clone()
    opt_lgt = torch.optim.Adam([light_base], lr=0.0)
    step = F.make_fit_step(fitter, cfg, renderer, 0)
    with torch.no_grad():
        gt_pts = sample_points(ref.v_pos, ref.t_pos_idx, 2000, uniform)
    cd0 = _chamfer_to(fitter, state, gt_pts, uniform)
    np_rng = np.random.default_rng(0)
    img_hist, regrows, grown, it = [], 0, [], 0
    t0 = time.perf_counter()
    while it < cfg.iter:
        target = renderer.random_target(1, np_rng)
        saved = (state, state.sdf.detach().clone(), state.deform.detach().clone(),
                 copy.deepcopy(opt_geo.state_dict()), light_base.detach().clone(),
                 copy.deepcopy(opt_lgt.state_dict()), gen.get_state())
        new, metrics = step(state, light_base, opt_geo, opt_lgt, target, it, uniform)
        over = {k: int(metrics[k]) for k in ('raster_overflow', 'raster_overflow_global',
                                             'raster_overflow_live', 'shade_overflow',
                                             'aa_overflow')}
        updates = {name: grow_capacity(getattr(cfg, name), over[key], F._FIT_CAP_MAX[name])
                   for name, key in F.RASTER_CAPS if over[key] > 0}
        if over['shade_overflow'] > 0:
            cur = res[0] * res[1] // 4 if cfg.shade_cap < 0 else cfg.shade_cap
            updates['shade_cap'] = grow_capacity(cur, over['shade_overflow'], res[0] * res[1])
        if over['aa_overflow'] > 0:
            cur = cfg.aa_budget or cfg.batch * (res[0] + res[1]) * 8
            updates['aa_budget'] = grow_capacity(cur, over['aa_overflow'], first=2)
        if updates:
            # redo the step from its snapshot with the grown capacities
            state, sdf, deform, geo_sd, lb, lgt_sd, rng_state = saved
            with torch.no_grad():
                state.sdf.copy_(sdf)
                state.deform.copy_(deform)
                light_base.copy_(lb)
            opt_geo.load_state_dict(geo_sd)
            opt_lgt.load_state_dict(lgt_sd)
            gen.set_state(rng_state)
            cfg = dataclasses.replace(cfg, **updates)
            step = F.make_fit_step(fitter, cfg, renderer, 0)
            regrows += 1
            grown.append((it, updates))
            assert regrows < 10, grown
            continue
        state = new
        img_hist.append(float(metrics['img_loss']))
        it += 1
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    fit_s = time.perf_counter() - t0
    cd1 = _chamfer_to(fitter, state, gt_pts, uniform)
    q = len(img_hist) // 4
    lb = light_base.detach()
    return {'seed': seed, 'cd0': cd0, 'cd1': cd1, 'img_first_q': float(np.mean(img_hist[:q])),
            'img_last_q': float(np.mean(img_hist[-q:])),
            'light_moved': float((lb - light_base0).abs().max()), 'light_min': float(lb.min()),
            'regrows': grown, 'fit_s': fit_s, 'steps_run': iters + regrows,
            'pool_renders': renderer.target_pool}


def gate_failures(runs: list) -> list:
    """The JAX gate's thresholds (tests/test_fit_convergence.py:120-135)
    that ``runs`` (:func:`fit_gate`'s numbers, one a seed) miss. Each run
    is held to those on the fitted mesh and the fit's course; ``cd1 < 0.5
    cd0`` is held on the means over the runs: cd0 is the random start's
    chamfer, which spreads with the draw while cd1 does not (ROADMAP
    Queue 3)."""
    import math
    import numpy as np
    checks = []
    for r in runs:
        checks += [(f'seed {r["seed"]}: {name}', ok) for name, ok in (
            ('cd1 finite', math.isfinite(r['cd1'])),
            ('light base moved', r['light_moved'] > 0),
            ('light base >= 0', r['light_min'] >= 0),
            ('cd1 < 0.025', r['cd1'] < 0.025),
            ('img last quartile < 0.10 x first', r['img_last_q'] < 0.10 * r['img_first_q']))]
    checks.append(('mean cd1 < 0.5 mean cd0', np.mean([r['cd1'] for r in runs])
                   < 0.5 * np.mean([r['cd0'] for r in runs])))
    return [name for name, ok in checks if not ok]


def ablation_arm(tg, work: str, dev, aa: bool, iters: int = ABL_ITERS, seed: int = 1):
    """One arm of the JAX package's AA ablation (tools/aa_ablation.py
    ``run_arm``) on the port, from the draws of ``seed``: the gate's sphere, ``iters`` pass-1
    iterations at 64^2, batch 1, raster_K 2048, the light fixed, edge AA on
    or off; then the chamfer distance and the PSNR over 4 circular
    validation poses. Returns (chamfer, PSNR dB, steps)."""
    import numpy as np
    import torch
    from meshdiffusion_tpu_torch.fitting import fit as F
    from meshdiffusion_tpu_torch.fitting.dataset import TargetRenderer
    from meshdiffusion_tpu_torch.fitting.geometry import DMTetFitter
    from meshdiffusion_tpu_torch.geometry.fit_losses import sample_points
    from meshdiffusion_tpu_torch.render.render import render_mesh
    ref, env = _gate_reference(tg, work, dev)
    res = (64, 64)
    cfg = F.FitConfig(iter=iters, batch=1, train_res=res, dmtet_grid=tg.resolution,
                      mesh_scale=1.0, surface_samples=2000, raster_K=2048, normal_only=True,
                      learn_light=True, cam_radius=2.0, antialias=aa)
    fitter = DMTetFitter(grid=tg, scale=1.0, deform_scale=2.0, sdf_regularizer=0.2,
                         total_iter=cfg.iter, buffer_capacity=50)
    gen, uniform, state = _gate_draws(fitter, dev, seed)
    renderer = TargetRenderer(ref_mesh=ref, envlight=env, cam_radius=2.0, train_res=res,
                              num_surface_samples=2000, generator=gen)
    state = state.replace(sdf=state.sdf.requires_grad_(), deform=state.deform.requires_grad_())
    opt_geo = torch.optim.Adam([state.sdf, state.deform], lr=0.0)
    step = F.make_fit_step(fitter, cfg, renderer, 0)
    np_rng = np.random.default_rng(0)
    for it in range(cfg.iter):
        # the light fixed (light_base None), as the JAX arms
        state, metrics = step(state, None, opt_geo, None, renderer.random_target(1, np_rng), it,
                              uniform)
        assert int(metrics['raster_overflow']) == 0, it
    with torch.no_grad():
        gt_pts = sample_points(ref.v_pos, ref.t_pos_idx, 2000, uniform)
        cd = _chamfer_to(fitter, state, gt_pts, uniform)
        m = fitter.get_mesh(state)
        m.material = F.default_material(dev)
        mses = []
        for k in range(4):
            _, mvp, campos = renderer.rotate_camera(k * 12)
            tgt = renderer.render_target(mvp, campos)
            pred = render_mesh(m, tgt['mvp'], tgt['campos'], env, res, num_layers=1,
                               raster_K=2048)
            mses.append(float(torch.mean((pred['shaded'][..., :3] - tgt['img'][..., :3]) ** 2)))
    return cd, float(-10.0 * np.log10(max(np.mean(mses), 1e-10))), cfg.iter


def _aa_pass_ms(calls, dev) -> dict:
    """Device ms (torch.profiler) and CUDA-event ms of a render's edge AA
    replayed from its recorded calls [(fn, args, kwargs)]: forward alone,
    and forward + backward (the gradients w.r.t. each call's colour and
    v_clip of a fixed weighting of its image)."""
    import torch
    leaves = []
    for fn, args, kw in calls:
        args = [a.detach() if torch.is_tensor(a) else a for a in args]
        vi = 4 if fn.__name__ == 'antialias_views' else 2       # v_clip's place
        args[0] = args[0].clone().requires_grad_()
        args[vi] = args[vi].clone().requires_grad_()
        leaves.append((fn, args, kw, vi))
    gen = torch.Generator(dev).manual_seed(5)
    wgts = [torch.rand(a[0].shape, generator=gen, device=dev) for _, a, _, _ in leaves]

    def run(grad: bool):
        outs = []
        for fn, args, kw, vi in leaves:
            out = fn(*args, **kw)
            out = out[0] if isinstance(out, tuple) else out
            if grad:
                outs.append(torch.autograd.grad((out * wgts[len(outs)]).sum(),
                                                (args[0], args[vi])))
        return outs

    with torch.no_grad():
        fwd = lambda: run(False)
        fwd_ms = sum(_device_ms(fwd, 5).values())
        fwd_ev = _time_ms(fwd, 5, 1)
    both = lambda: run(True)
    return {'calls': len(calls), 'fwd_device_ms': fwd_ms, 'fwd_events_ms': fwd_ev,
            'fwd_bwd_device_ms': sum(_device_ms(both, 5).values()),
            'fwd_bwd_events_ms': _time_ms(both, 5, 1)}


AA_RES, AA_BATCH = (512, 512), 4       # phase 24 (a): FitConfig's train_res and batch


def aa_alternates_run(gt_path: str, dev, record, per_shape) -> dict:
    """Phase 24 (a): the GT mesh (torus united with box, phase 7's) rendered
    at 512^2, batch 4, two layers, through ``render_mesh`` under each
    MESHDIFFUSION_AA_IMPL (capacities grown until nothing drops: raster_K,
    raster_Kg, and compact's aa_budget); flat's and vmap's images and the
    gradient of a fixed image loss w.r.t. v_pos held against compact's
    (max-abs 1e-5; relative L2 1e-4), aa_overflow 0 in each; each arm's
    tile_zmin call held bit-equal to plain; the AA pass replayed for its
    device time."""
    import numpy as np
    import torch
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.fitting.dataset import TargetRenderer
    from meshdiffusion_tpu_torch.render import light as light_mod
    from meshdiffusion_tpu_torch.render import mesh as mesh_mod
    from meshdiffusion_tpu_torch.render import obj as obj_mod
    from meshdiffusion_tpu_torch.render import rasterize as raster
    from meshdiffusion_tpu_torch.render import render as render_mod
    from meshdiffusion_tpu_torch.render.rasterize import grow_capacity
    from meshdiffusion_tpu_torch.fitting.fit import default_material
    ref = obj_mod.load_mesh(gt_path, device=dev)
    ref = mesh_mod.center_by_reference(ref, mesh_mod.aabb(ref.v_pos), 1.0)
    ren = TargetRenderer(ref_mesh=ref, envlight=None, cam_radius=3.0, train_res=AA_RES)
    _, mvp, campos = ren.random_cameras(AA_BATCH, np.random.default_rng(0))
    gen = torch.Generator(dev).manual_seed(3)
    lgt = light_mod.create_trainable_env_rnd(64, scale=0.5, bias=0.25, generator=gen, device=dev)
    lgt.build_mips()
    wgt = torch.randn((AA_BATCH,) + AA_RES + (4,), generator=gen, device=dev)
    caps = {'raster_K': 256, 'raster_Kg': 64, 'aa_budget': None}
    out = {}
    for impl in AA_IMPLS:
        zcalls, aa_calls = [], []
        launch = raster.tile_zmin
        views_fn, one_fn = render_mod.antialias_views, render_mod.antialias

        def zrec(*args):
            o = launch(*args)
            zcalls.append((args, o))
            return o

        def rec(fn):
            def wrapped(*args, **kw):
                aa_calls.append((fn, args, kw))
                return fn(*args, **kw)
            return wrapped
        while True:
            v_pos = ref.v_pos.detach().clone().requires_grad_()
            m = mesh_mod.auto_normals(mesh_mod.Mesh(v_pos=v_pos, t_pos_idx=ref.t_pos_idx,
                                                    material=default_material(dev)))
            zcalls.clear()
            aa_calls.clear()
            ops.reset_launch_counts()
            raster.tile_zmin, render_mod.antialias_views = zrec, rec(views_fn)
            render_mod.antialias = rec(one_fn)
            try:
                with aa_impl(impl):
                    o = render_mod.render_mesh(m, mvp, campos, lgt, AA_RES, num_layers=2,
                                               raster_K=caps['raster_K'],
                                               raster_Kg=caps['raster_Kg'],
                                               aa_budget=caps['aa_budget'])
            finally:
                raster.tile_zmin, render_mod.antialias_views = launch, views_fn
                render_mod.antialias = one_fn
            launches = ops.launch_counts()
            over = {k: int(o[k]) for k in ('raster_overflow', 'raster_overflow_global',
                                           'raster_overflow_live', 'aa_overflow')}
            assert over['raster_overflow_live'] == 0, over
            if over['raster_overflow']:
                caps['raster_K'] = grow_capacity(caps['raster_K'], over['raster_overflow'])
            if over['raster_overflow_global']:
                caps['raster_Kg'] = grow_capacity(caps['raster_Kg'],
                                                  over['raster_overflow_global'])
            if over['aa_overflow']:
                cur = caps['aa_budget'] or AA_BATCH * sum(AA_RES) * 8
                caps['aa_budget'] = grow_capacity(cur, over['aa_overflow'], first=2)
            if not any(over.values()):
                break
            assert impl == 'compact', (impl, over)      # the others render at compact's capacities
        (o['shaded'] * wgt).sum().backward()
        assert launches['tile_zmin'] == 1 and len(zcalls) == 1, launches
        shaded = o['shaded'].detach()
        assert torch.isfinite(shaded).all() and float(o['mask'].mean()) > 0.02
        row = zmin_plain_check(zcalls[0], record, f'AA {impl} render {AA_RES[0]}^2 x{AA_BATCH}')
        per_shape.append(row)
        out[impl] = {'shaded': shaded, 'grad': v_pos.grad.detach(), 'launches': launches,
                     'aa': _aa_pass_ms(aa_calls, dev), 'zmin': row, 'caps': dict(caps)}
    base = out['compact']
    for impl in AA_IMPLS[1:]:
        img_err = float((out[impl]['shaded'] - base['shaded']).abs().max())
        grad_rel = _rel_l2(out[impl]['grad'], base['grad'])
        out[impl].update(img_max_abs_vs_compact=img_err, grad_rel_l2_vs_compact=grad_rel)
        assert img_err <= 1e-5 and grad_rel <= 1e-4, (impl, img_err, grad_rel)
    return {impl: {k: v for k, v in r.items() if k not in ('shaded', 'grad')}
            for impl, r in out.items()}


def fit_quality_run(dev) -> dict:
    """Phase 24 (b): the fit-quality gate (:func:`fit_gate` from each of
    GATE_SEEDS, :func:`gate_failures`) under each MESHDIFFUSION_AA_IMPL,
    every launch counter set to 0 just before each arm and read just after
    (tile_zmin once a render: the pool's 8 GT renders and every step run,
    each seed); then the AA ablation's two arms
    (:func:`ablation_arm`, compact AA on and AA off). Prints every arm's
    numbers, then fails if an arm missed one of JAX's thresholds."""
    import numpy as np
    from meshdiffusion_tpu_torch import ops
    tg = tiny_tet_grid()
    work = tempfile.mkdtemp(prefix='chip_smoke_gate_')
    out, launches = {'gate': {}, 'ablation': {}}, {}
    try:
        for impl in AA_IMPLS:
            ops.reset_launch_counts()
            with aa_impl(impl):
                runs = [fit_gate(tg, work, dev, seed) for seed in GATE_SEEDS]
            n = launches[f'fit_gate_{impl}'] = ops.launch_counts()
            renders = sum(r['pool_renders'] + r['steps_run'] for r in runs)
            assert n['tile_zmin'] == renders, (impl, n, renders)
            failed = gate_failures(runs)
            cd0, cd1 = (float(np.mean([r[k] for r in runs])) for k in ('cd0', 'cd1'))
            out['gate'][impl] = {'runs': runs, 'mean_cd0': cd0, 'mean_cd1': cd1,
                                 'failed': failed}
            for r in runs:
                print(f'fit gate, AA {impl}, seed {r["seed"]} (sphere r 0.3 on the 8^3 grid, '
                      f'48^2, batch 1, {GATE_ITERS} pass-1 iterations, learn_light, pool 8): cd0 '
                      f'{r["cd0"]:.5f} -> cd1 {r["cd1"]:.5f} (gate < 0.025; ratio '
                      f'{r["cd1"] / r["cd0"]:.3f}); image loss first quartile '
                      f'{r["img_first_q"]:.5f} -> last {r["img_last_q"]:.5f} (ratio '
                      f'{r["img_last_q"] / r["img_first_q"]:.4f}, gate < 0.10); light base moved '
                      f'{r["light_moved"]:.4f}, min {r["light_min"]:.4f}; {r["steps_run"]} steps '
                      f'run, capacity regrows {r["regrows"]}, {r["fit_s"]:.2f} s')
            print(f'fit gate, AA {impl}, seeds {list(GATE_SEEDS)}: mean cd0 {cd0:.5f} -> mean cd1 '
                  f'{cd1:.5f} (ratio {cd1 / cd0:.3f}, gate < 0.5); tile_zmin {n["tile_zmin"]}; '
                  + ('missed: ' + ', '.join(failed) if failed else 'every threshold met'))
        for arm, aa in (('on', True), ('off', False)):
            ops.reset_launch_counts()
            cd, psnr, iters = ablation_arm(tg, work, dev, aa)
            n = launches[f'aa_ablation_{arm}'] = ops.launch_counts()
            # a GT render and a fit step an iteration, then 4 validation poses x 2
            assert n['tile_zmin'] == 2 * iters + 8, n
            jcd, jpsnr = JAX_ABLATION[arm]
            out['ablation'][arm] = {'chamfer': cd, 'psnr_db': psnr, 'jax_chamfer': jcd,
                                    'jax_psnr_db': jpsnr}
            print(f'AA ablation, AA {arm}, seed 1 ({ABL_ITERS} iterations at 64^2, 4 validation poses): '
                  f'chamfer {cd:.5f}, PSNR {psnr:.2f} dB; the JAX package recorded {jcd} / '
                  f'{jpsnr} dB (JAX on the CPU, AA_ABLATION.md; a comparison, not a target); '
                  f'tile_zmin {n["tile_zmin"]}')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    missed = {impl: r['failed'] for impl, r in out['gate'].items() if r['failed']}
    assert not missed, f'the fit gate missed JAX\'s thresholds: {missed}'
    return {'json': out, 'launches': launches}


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--out', default=None, help='directory for the per-shape JSON')
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false', file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import meshdiffusion_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: the port is not beside this script: {e}', file=sys.stderr)
        return 1
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.config import get_config
    from meshdiffusion_tpu_torch.diffusion.sampling import StepTables
    from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
    from meshdiffusion_tpu_torch.geometry.obj_io import read_obj
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    from meshdiffusion_tpu_torch.main import main as port_main
    from meshdiffusion_tpu_torch.models import create_model, get_model
    from meshdiffusion_tpu_torch.models.layers import ResnetBlockDDPM
    from meshdiffusion_tpu_torch.ops import _build
    from meshdiffusion_tpu_torch.ops.roofline import bound_ms

    # ---- 1. the card ----
    smi = _smi()
    print(smi)
    import triton
    print(f'python {sys.version.split()[0]}  torch {torch.__version__}  cuda '
          f'{torch.version.cuda}  triton {triton.__version__}  '
          f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')

    # ---- 2. the build ----
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.lib()
    print(f'build: nvcc sm_90a {time.perf_counter() - t0:.2f} s')
    for line in _build.build_log.splitlines():
        if 'registers' in line or 'spill' in line:
            print('  ptxas:', line.strip())

    # kernel name -> max_abs_err, and ms, plain_ms, bound_ms, library_ms summed
    # over the shapes compared (each distinct main-path shape once)
    results = {}

    def record(name, err, ms, plain_ms, bound, by, library_ms=None, library_device_ms=None):
        r = results.setdefault(name, {'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0,
                                      'bound_ms': 0.0, 'bound_by': by, 'library_ms': None})
        r['max_abs_err'] = max(r['max_abs_err'], err)
        r['ms'] += ms
        r['plain_ms'] += plain_ms
        r['bound_ms'] += bound
        if by != r['bound_by']:
            r['bound_by'] = 'operations' if 'operations' in (by, r['bound_by']) else by
        if library_ms is not None:
            r['library_ms'] = (r['library_ms'] or 0.0) + library_ms
        if library_device_ms is not None:
            r['library_device_ms'] = r.get('library_device_ms', 0.0) + library_device_ms

    out_dir = args.out or os.path.join(HERE, 'chip_smoke_out')
    os.makedirs(out_dir, exist_ok=True)
    per_shape = []   # per-shape rows of phases 3 and 6, written to out_dir/kernel_shapes.json
    cfg = get_config('res64')
    R = cfg.data.image_size
    mask = torch.as_tensor(TetGrid.load(R).grid_mask(), device=dev)[None, ..., None]
    g = torch.Generator(device=dev).manual_seed(0)

    # the full-width model: seeded normal(0, 0.02) weights for every tensor
    # (the DDPM init zeroes each block's last conv, which would hide errors)
    model_k = _seeded(cfg, dev, g)

    # capture the main path's K3 / K2 input shapes (and how often each runs)
    # from one plain forward, on the meta device: model_k's first forward
    # (phase 4) still builds its weight layouts
    x_in = torch.randn((1, R, R, R, 4), device=dev, generator=g)
    labels = torch.full((1,), 500.0, device=dev)
    with torch.device('meta'):
        conv_calls, head = capture_conv_shapes(
            get_model(cfg.model.name).from_config(cfg).eval(), torch.empty(x_in.shape),
            torch.empty(labels.shape), torch.empty(mask.shape, dtype=mask.dtype))
    conv_shapes = set(conv_calls)
    print(f'main path: {sum(conv_calls.values())} gn_silu_conv3d calls a forward at '
          f'{len(conv_shapes)} distinct shapes; output head GroupNorm+SiLU at {head["shape"]} '
          f'{head["dtype"]}')

    # ---- 3. each kernel against its plain version ----
    with torch.inference_mode():
        tables = StepTables.build(VPSDE(N=cfg.model.num_scales))
        shape = (1, R, R, R, 4)
        x, e, nz = (torch.randn(shape, device=dev, generator=g) for _ in range(3))
        err = 0.0
        for i in (0, 500, 998):
            beta, std = float(tables.beta[i]), float(tables.std[i])
            kx, km = ops.ancestral_update(x, e, mask, nz, beta, std)
            px, pm = ops.ancestral_update_reference(x, e, mask, nz, beta, std)
            torch.testing.assert_close(kx, px, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(km, pm, rtol=1e-5, atol=1e-5)
            err = max(err, float((kx - px).abs().max()), float((km - pm).abs().max()))
        ms = _time_ms(lambda: ops.ancestral_update(x, e, mask, nz, beta, std), 50)
        pms = _time_ms(lambda: ops.ancestral_update_reference(x, e, mask, nz, beta, std), 50)
        record('ancestral_update', err, ms, pms,
               *bound_ms(*ops.ancestral_update_cost(shape, mask.shape)))
        print(f'K1 ancestral_update {shape} f32: max_abs_err {err:.3e} (bound 1e-5) '
              f'kernel {ms:.4f} ms plain {pms:.4f} ms')

        C = head['shape'][-1]
        sc = 1.0 + 0.1 * torch.randn(C, device=dev, generator=g)
        bi = 0.1 * torch.randn(C, device=dev, generator=g)
        for dt in (head['dtype'], torch.bfloat16):
            xg = (torch.randn(head['shape'], device=dev, generator=g) * 2 + 0.5).to(dt)
            a, b = ops.gn_affine(xg, sc, bi)
            ra, rb = ops.gn_affine_reference(xg, sc, bi)
            torch.testing.assert_close(a, ra, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(b, rb, rtol=1e-5, atol=1e-5)
            err_s = max(float((a - ra).abs().max()), float((b - rb).abs().max()))
            y, r = ops.groupnorm_silu(xg, sc, bi), ops.groupnorm_silu_reference(xg, sc, bi)
            tol = 1e-5 if dt == torch.float32 else 1.6e-2    # bf16: one output rounding
            torch.testing.assert_close(y.float(), r.float(), rtol=tol, atol=tol)
            err_a = float((y.float() - r.float()).abs().max())
            ms_s = _time_ms(lambda: ops.gn_affine(xg, sc, bi), 20)
            pms_s = _time_ms(lambda: ops.gn_affine_reference(xg, sc, bi), 20)
            ms_a = _time_ms(lambda: ops.groupnorm_silu(xg, sc, bi), 20)
            pms_a = _time_ms(lambda: ops.groupnorm_silu_reference(xg, sc, bi), 20)
            print(f'K2 gn_affine (gn_stats) {head["shape"]} {dt}: max_abs_err {err_s:.3e} '
                  f'(bound 1e-5) kernel {ms_s:.4f} ms plain {pms_s:.4f} ms')
            print(f'K2 groupnorm_silu (stats + apply) {head["shape"]} {dt}: max_abs_err '
                  f'{err_a:.3e} (bound {tol:g}) kernel {ms_a:.4f} ms plain {pms_a:.4f} ms')
            if dt == head['dtype']:       # the JSON line reports the main path's dtype
                record('gn_affine', err_s, ms_s, pms_s,
                       *bound_ms(*ops.gn_affine_cost(xg.shape, dt)), *_var_mean_ms(xg))
                record('groupnorm_silu', err_a, ms_a, pms_a,
                       *bound_ms(*ops.groupnorm_silu_cost(xg.shape, dt)))

        conv_shape_checks(conv_calls, dev, g, record, per_shape)
        nin_shape_checks(conv_calls, dev, g, record, per_shape)
    k3 = [r for r in per_shape if r['name'] == 'gn_silu_conv3d']
    results['gn_silu_conv3d']['conv_only_ms'] = sum(r['conv_only_ms'] for r in k3)
    fwd_dev = (None if any(r['device_ms'] is None for r in k3)
               else sum(r['calls_per_forward'] * r['device_ms'] for r in k3))
    fwd_bnd = sum(r['calls_per_forward'] * r['bound_ms'] for r in k3)
    print(f'K3 summed over the {len(conv_shapes)} distinct shapes: kernel '
          f'{results["gn_silu_conv3d"]["ms"]:.3f} ms plain {results["gn_silu_conv3d"]["plain_ms"]:.3f} ms; '
          f'weighted by calls a forward: device {_ms(fwd_dev)} ms against a bound of {fwd_bnd:.3f} ms')
    slower = [(r['x'], r['dtype'], r['O']) for r in k3 if r['ms'] >= r['plain_ms']]
    assert not slower, f'K3 slower than its plain version at {slower}'
    # the hot shape of gen64-b4 (tiling 0, the descriptor route), outside the sums above
    b4 = []
    with torch.inference_mode():
        conv_shape_checks({((4, R, R, R, 128), torch.bfloat16, 128): 0}, dev, g,
                          lambda *args: None, b4)
    assert b4[0]['route'] == 'descriptor', b4
    per_shape.extend(b4)

    # ---- 4. the full-width forward, kernels on against off ----
    with torch.inference_mode():
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_k = model_k(x_in, labels, mask)     # the first: builds the convs' weight layouts
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1000.0
        per_fwd = ops.launch_counts()
        desc_fwd = ops.gn_silu_conv3d.descriptor_launches
        with ops.plain():
            y_p = model_k(x_in, labels, mask)
        rel = _rel_l2(y_k, y_p)
        assert torch.isfinite(y_k).all() and y_k.shape == x_in.shape
        assert rel <= 1e-2, rel
        assert per_fwd == _launches(gn_affine=75, groupnorm_silu=1, gn_silu_conv3d=74,
                                    nin_residual=22), per_fwd
        assert desc_fwd == 28, desc_fwd          # the O = 128 convs at 64^3 and 32^3
        fwd = {'kernels': [], 'plain': []}
        for which in ('plain', 'kernels', 'kernels', 'plain'):
            with ops.plain() if which == 'plain' else contextlib.nullcontext():
                fwd[which].append(_time_ms(lambda: model_k(x_in, labels, mask), 3, 1))
        nz = torch.randn(x_in.shape, device=dev, generator=g)
        step = lambda: ops.ancestral_update(x_in, model_k(x_in, labels, mask), mask, nz, 0.01, 0.5)
        step_ms = _time_ms(step, 10, 2)
        n_prof = 3
        prof = _device_ms(step, n_prof)
    per_fwd_dev = {n: _of(prof, n) for n in _KERNEL_NAMES}    # one forward a step
    busy = sum(prof.values())
    ms_k, ms_p = (sum(v) / len(v) for v in (fwd['kernels'], fwd['plain']))
    print(f'res64 full-width forward, batch 1, bf16: rel_l2 kernels vs plain {rel:.3e} '
          f'(bound 1e-2); kernels {ms_k:.2f} ms plain {ms_p:.2f} ms per forward '
          f'({fwd})')
    print(f'launches in one forward: {per_fwd}, {desc_fwd} of K3\'s on the descriptor route; '
          f'the first forward {first_ms:.1f} ms (it builds '
          f'every conv\'s weight layouts); a warm U-Net step (forward + ancestral update, '
          f'10 in a row) {step_ms:.2f} ms')
    print(f'device time a U-Net step (torch.profiler over {n_prof} steps): all kernels {busy:.3f} ms, '
          f'{100 * busy / step_ms:.0f} % of the {step_ms:.2f} ms a warm step takes unprofiled (the '
          f'rest: the card idle, waiting on the host); '
          + ', '.join(f'{n} {t:.3f} ms' for n, t in per_fwd_dev.items() if t))
    for k, t in sorted(prof.items(), key=lambda kv: -kv[1])[:12]:
        print(f'  {t:8.3f} ms  {k[:100]}')
    del model_k
    torch.cuda.empty_cache()

    # ---- 5. the entry points: uncond_gen then extract ----
    rec = _Records()
    logging.getLogger('meshdiffusion_tpu_torch').addHandler(rec)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        steps = 9
        ops.reset_launch_counts()
        npy = port_main(['--config', 'res64', '--mode', 'uncond_gen', '--device', 'cuda',
                         f'--config.model.num_scales={steps + 1}',
                         '--config.model.beta_max=2.0', '--config.eval.batch_size=1',
                         f'--config.eval.eval_dir={tmp}'])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        sample_s = rec.fields['sample_s']
        print(f'uncond_gen: {rec.fields["steps"]} steps in {sample_s:.3f} s, '
              f'{1000 * sample_s / steps:.2f} ms per U-Net step; launches {launches}')
        assert launches == _launches(ancestral_update=steps, gn_affine=75 * steps,
                                     groupnorm_silu=steps, gn_silu_conv3d=74 * steps,
                                     nin_residual=22 * steps), launches
        sample = np.load(npy)
        m = mask[0, ..., 0].cpu().numpy()
        assert sample.shape == (1, 4, R, R, R) and np.isfinite(sample).all()
        assert not (sample[0] * (1 - m)).any(), 'sample is non-zero outside the grid mask'
        assert np.abs(sample[0] * m).max() > 0
        objs = port_main(['--mode', 'extract', '--sample_path', npy, '--out_dir',
                          os.path.join(tmp, 'meshes'), '--device', 'cuda'])
        v, f = read_obj(objs[0])
        print(f'extract: {objs[0]}: {len(v)} verts, {len(f)} faces; marching tets '
              f'{rec.fields["marching_s"]:.3f} s, post-process (remesh, smooth 3, remesh) '
              f'{rec.fields["postprocess_s"]:.3f} s')
        assert len(f) >= 1 and np.isfinite(v).all()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 6. the tile z-test kernel at the fit path's shapes ----
    from meshdiffusion_tpu_torch.fitting.fit import FitConfig
    keep = tempfile.mkdtemp(prefix='chip_smoke_keep_')   # phase 7's dict, the 128 grid's cache
    fcfg = FitConfig()
    H, W = fcfg.train_res
    B = fcfg.batch
    tmp = tempfile.mkdtemp(prefix='chip_smoke_fit_')
    try:
        gt = os.path.join(tmp, 'gt.obj')
        gt_mesh(gt)
        for name, K, zargs, over in zmin_cases(gt, dev):
            with torch.inference_mode():
                call = lambda: ops.tile_zmin(*zargs, (H, W), num_layers=2)
                kt, kz = call()
                pt, pz = ops.tile_zmin_reference(*zargs, (H, W), num_layers=2)
                hits = [int((pt[li] >= 0).sum()) for li in range(2)]
                assert torch.equal(kt, pt) and torch.equal(kz, pz) and hits[0] > 10000, (name, hits)
                zerr = float((kz - pz).abs().max())
                N = zargs[1].shape[0]
                live = zargs[2].view(B, -1) + zargs[4][:, None]
                pairs, heaviest = int(live.sum()), int(live.max())
                ms = _time_ms(call, 20)
                dms, seen, issued = _kernel_ms(call, 'tile_zmin')
                # with the wrapper's sort of the tiles by live count; a call's
                # device time cannot exceed its CUDA-event time
                sort_ms = sum(t for k, t in _device_ms(call).items() if 'tile_zmin_kernel' not in k)
                call_dev = None if dms is None else dms + sort_ms
                check = ''
                if call_dev is not None and call_dev > 1.05 * ms:
                    check = f' (the profiler gave {dms:.4f} ms, more than the events allow)'
                    dms = call_dev = None
                pms = _time_ms(lambda: ops.tile_zmin_reference(*zargs, (H, W), num_layers=2), 3, 1)
                # the second layer tests only the pixels the first hit; the
                # count over every pixel is kept beside it for comparison
                bnd, by = ops.tile_zmin_bound_ms(zargs[0], zargs[2], zargs[4], (H, W),
                                                 num_layers=2, best_z=kz)
                bnd_all = ops.tile_zmin_bound_ms(zargs[0], zargs[2], zargs[4], (H, W),
                                                 num_layers=2)[0]
                row = {'name': 'tile_zmin', 'case': name, 'tiles': N, 'K': K,
                       'Kg': zargs[3].shape[1], 'faces': zargs[0].shape[1], 'pairs': pairs,
                       'heaviest_tile': heaviest, 'hits': hits, 'ms': ms, 'device_ms': dms,
                       'launches_recorded': [seen, issued], 'call_device_ms': call_dev,
                       'plain_ms': pms, 'bound_ms': bnd, 'bound_by': by,
                       'bound_every_pixel_ms': bnd_all, 'library_ms': None, 'overflow': over}
                share = '' if dms is None else f', {100 * bnd / dms:.0f} % reached'
                print(f'tile_zmin {name}: {B} views x {N // B} tiles, {zargs[0].shape[1]} faces a '
                      f'view, {pairs} live (candidate, tile) pairs, the heaviest tile {heaviest}; '
                      f'both layers in one launch: ids equal and z bit-equal to plain, {hits} '
                      f'pixels hit; device {_ms(dms)} ms (profiler recorded {seen} of {issued} '
                      f'launches{check}; with the sort {_ms(call_dev)}), CUDA events {ms:.4f} ms '
                      f'(less the sort {ms - sort_ms:.4f}); plain {pms:.2f} ms; bound {bnd:.4f} ms '
                      f'({by}{share}; {bnd_all:.4f} ms if the second layer tested every pixel); '
                      f'binning overflow (tile, global) a view {over}')
                if K == fcfg.raster_K:
                    gt_out = (kt, kz)
                elif name.startswith('GT'):
                    # the K 256 lists again, in rows of K: what the padding alone costs
                    cut = zargs[:2] + (zargs[2].clamp(max=fcfg.raster_K),) + zargs[3:]
                    cut_call = lambda: ops.tile_zmin(*cut, (H, W), num_layers=2)
                    ct, cz = cut_call()
                    assert torch.equal(ct, gt_out[0]) and torch.equal(cz, gt_out[1]), name
                    row['cut_device_ms'], seen, issued = _kernel_ms(cut_call, 'tile_zmin')
                    print(f'  {name}: the K {fcfg.raster_K} lists in rows of {K}: the same ids '
                          f'and z as at K {fcfg.raster_K}, device {_ms(row["cut_device_ms"])} ms '
                          f'(profiler recorded {seen} of {issued} launches)')
                per_shape.append(row)
            record('tile_zmin', zerr, ms, pms, bnd, by)

        # ---- 7. the fit path through its entry point ----
        ops.reset_launch_counts()
        written, peak, passes = fit_run(port_main, rec, gt, os.path.join(tmp, 'fit'))
        fit_launches = ops.launch_counts()
        assert len(written) == 1 and len(passes) == 2, (written, passes)
        steps_run = sum(p[2] for p in passes)
        expect = FIT_POOL + steps_run         # one launch a render: GT pool + fit steps
        assert fit_launches == _launches(tile_zmin=expect), (fit_launches, expect)
        V = TetGrid.load(64).num_verts
        fitted = os.path.join(keep, os.path.basename(written[0]['tets']))
        shutil.copy(written[0]['tets'], fitted)        # phase 13 converts it
        pre, fin = (torch.load(written[0][k]) for k in ('tets_pre', 'tets'))
        assert set(pre) == {'sdf', 'sdf_ema', 'deform', 'deform_unmasked'}, set(pre)
        assert set(fin) == {'sdf', 'deform', 'deform_unmasked'}, set(fin)
        for d in (pre, fin):
            assert d['sdf'].shape == (V,) and d['deform'].shape == (V, 3)
            assert d['deform_unmasked'].shape == (V, 3)
            assert all(torch.isfinite(t).all() for t in d.values())
        assert set(fin['sdf'].unique().tolist()) <= {-1.0, 1.0}
        losses = [loss for _, _, loss in rec.fit_losses]
        assert len(losses) >= 2 * (FIT_ITERS - 1) and all(np.isfinite(losses)), rec.fit_losses
        first, last = rec.fit_losses[0], rec.fit_losses[-1]
        show_fit('', passes, peak)
        print(f'fit_dmtets: V={V}, losses pass{first[0] + 1} iter {first[1]} {first[2]:.4f} -> '
              f'pass{last[0] + 1} iter {last[1]} {last[2]:.4f}; launches {fit_launches} '
              f'(= {FIT_POOL} GT renders + {steps_run} fit steps)')

        # ---- 8. single-view fitting through its entry point ----
        ops.reset_launch_counts()
        dmtet, peak, one_layer = singleview_run(port_main, gt, os.path.join(tmp, 'sv'))
        sv_launches = ops.launch_counts()
        # one launch a render: the GT target, every step, the visibility render
        assert sv_launches == _launches(tile_zmin=1 + SV_ITERS + 1), sv_launches
        n_it, sv_s, sv_over = rec.fields['singleview_fit']
        assert n_it == SV_ITERS and len(one_layer) == 1, (n_it, len(one_layer))
        zargs, (kt, kz) = one_layer[0]
        with torch.inference_mode():
            pt, pz = ops.tile_zmin_reference(*zargs)
            assert torch.equal(kt, pt) and torch.equal(kz, pz) and int((pt >= 0).sum()) > 1000
            call = lambda: ops.tile_zmin(*zargs)
            ms = _time_ms(call, 20)
            dms, seen, issued = _kernel_ms(call, 'tile_zmin')
            pms = _time_ms(lambda: ops.tile_zmin_reference(*zargs), 3, 1)
            bnd, by = ops.tile_zmin_bound_ms(zargs[0], zargs[2], zargs[4], zargs[5], num_layers=1,
                                             best_z=kz)
        if dms is not None and dms > 1.05 * ms:
            dms = None
        record('tile_zmin', 0.0, ms, pms, bnd, by)
        live = zargs[2].view(zargs[4].shape[0], -1) + zargs[4][:, None]
        per_shape.append({'name': 'tile_zmin', 'case': 'single-view visibility render, one layer',
                          'tiles': zargs[1].shape[0], 'faces': zargs[0].shape[1],
                          'pairs': int(live.sum()), 'heaviest_tile': int(live.max()),
                          'hits': [int((pt >= 0).sum())], 'ms': ms, 'device_ms': dms,
                          'launches_recorded': [seen, issued], 'plain_ms': pms, 'bound_ms': bnd,
                          'bound_by': by, 'library_ms': None})
        d = torch.load(dmtet)
        assert set(d) == {'sdf', 'deform', 'vis', 'vis_rast'}, set(d)
        assert d['sdf'].shape == d['vis'].shape == d['vis_rast'].shape == (V,)
        assert d['deform'].shape == (V, 3) and d['vis_rast'].dtype == torch.bool
        assert set(d['sdf'].unique().tolist()) <= {-1.0, 1.0}
        assert 0 < float(d['vis'].sum()) < V and bool((d['vis_rast'] >= (d['vis'] > 0)).all())
        print(f'fit_singleview: {SV_ITERS} iterations in {sv_s:.3f} s, {sv_s / SV_ITERS:.3f} s a '
              f'step (the GT bootstrap every 10 inside); peak device memory {peak / 2 ** 30:.3f} '
              f'GiB above what was held before it; largest overflow counts a step {sv_over}; '
              f'launches {sv_launches} (= 1 GT render + {SV_ITERS} steps + 1 visibility render); '
              f'vis {int(d["vis"].sum())} of {V} vertices, vis_rast {int(d["vis_rast"].sum())}')
        print(f'tile_zmin one layer (the visibility render, 512^2, 1 view, K '
              f'{FitConfig().raster_K} + 64): ids equal and z bit-equal to plain, {int((pt >= 0).sum())} pixels hit; '
              f'device {_ms(dms)} ms (profiler recorded {seen} of {issued} launches), CUDA events '
              f'{ms:.4f} ms; plain {pms:.2f} ms; bound {bnd:.4f} ms ({by})')

        # ---- 9. a checkpoint in the reference's format ----
        from meshdiffusion_tpu_torch.utils.checkpoint import EMA, load_eval_weights, save_checkpoint
        gk = torch.Generator(device=dev).manual_seed(1)
        model = create_model(cfg, dev, gk)
        ema = EMA(model)
        with torch.no_grad():
            for v in ema.shadow.values():           # shadow values distinct from the weights
                v.add_(1e-3 * torch.randn(v.shape, device=dev, generator=gk))
        t0 = time.perf_counter()
        ckpt = save_checkpoint(os.path.join(tmp, 'checkpoint.pth'),
                               {'model': model, 'ema': ema, 'optimizer': None, 'step': 0}, cfg)
        save_s = time.perf_counter() - t0
        raw = torch.load(ckpt, map_location='cpu', weights_only=True)
        n_params = sum(1 for _ in model.parameters())
        assert all(k.startswith('module.') for k in raw['model']) and \
            len(raw['ema']['shadow_params']) == len(raw['model']) == n_params
        del raw
        eval_model = create_model(cfg, dev, torch.Generator(device=dev).manual_seed(2))
        t0 = time.perf_counter()
        load_eval_weights(ckpt, eval_model, cfg)
        load_s = time.perf_counter() - t0
        for k, p in eval_model.named_parameters():
            assert torch.equal(p, ema.shadow[k]), k
        print(f'checkpoint: {n_params} tensors, {os.path.getsize(ckpt) / 2 ** 30:.2f} GiB written '
              f'in {save_s:.2f} s (model with module. keys + EMA list); loaded onto a fresh eval '
              f'model in {load_s:.2f} s, every parameter bit-equal to its EMA shadow')
        del model, ema, eval_model
        torch.cuda.empty_cache()

        # ---- 10. cond_gen from that checkpoint and the single-view dict, then extract ----
        ops.reset_launch_counts()
        npy = port_main(['--config', 'res64', '--mode', 'cond_gen', '--device', 'cuda',
                         f'--config.model.num_scales={COND_STEPS}', '--config.model.beta_max=2.0',
                         '--config.eval.batch_size=1', f'--config.eval.freeze_iters={FREEZE}',
                         f'--config.eval.ckpt_path={ckpt}',
                         f'--config.eval.partial_dmtet_path={dmtet}',
                         f'--config.eval.eval_dir={os.path.join(tmp, "cond")}'])
        torch.cuda.synchronize()
        cond_launches = ops.launch_counts()
        assert cond_launches == _launches(
            ancestral_update=COND_STEPS, gn_affine=75 * COND_STEPS, groupnorm_silu=COND_STEPS,
            gn_silu_conv3d=74 * COND_STEPS, nin_residual=22 * COND_STEPS), cond_launches
        cond_s = rec.fields['sample_s']
        sample = np.load(npy)
        m = mask[0, ..., 0].cpu().numpy()
        assert sample.shape == (1, 4, R, R, R) and np.isfinite(sample).all()
        assert not (sample[0] * (1 - m)).any(), 'cond sample is non-zero outside the grid mask'
        c = TetGrid.load(R).vert_grid_coords
        seen = d['vis'].numpy() > 0
        agree = float((np.sign(sample[0, 0, c[seen, 0], c[seen, 1], c[seen, 2]])
                       == d['sdf'].numpy()[seen]).mean())
        assert agree > 0.6, agree
        objs = port_main(['--mode', 'extract', '--sample_path', npy, '--out_dir',
                          os.path.join(tmp, 'cond_mesh'), '--device', 'cuda', '--no_remesh'])
        v, f = read_obj(objs[0])
        assert len(f) >= 1 and np.isfinite(v).all()
        print(f'cond_gen: {COND_STEPS} steps (freeze_iters {FREEZE}) in {cond_s:.3f} s, '
              f'{1000 * cond_s / COND_STEPS:.2f} ms per step; launches {cond_launches}; the SDF '
              f'sign agrees with the partial at {agree:.4f} of the {int(seen.sum())} visible '
              f'vertices; extract (smooth 3, no remesh): {len(v)} verts, {len(f)} faces')

        # ---- 11. uncond_gen_interp: DDIM, 1000 scales, the 100-step quad schedule ----
        ops.reset_launch_counts()
        npy = port_main(['--config', 'res64', '--mode', 'uncond_gen_interp', '--device', 'cuda',
                         '--config.eval.batch_size=2', f'--config.eval.ckpt_path={ckpt}',
                         f'--config.eval.eval_dir={os.path.join(tmp, "interp")}'])
        torch.cuda.synchronize()
        interp_launches = ops.launch_counts()
        fwd = 99                                 # 100 quad-schedule times, 99 pairs
        assert interp_launches == _launches(gn_affine=75 * fwd, groupnorm_silu=fwd,
                                            gn_silu_conv3d=74 * fwd, nin_residual=22 * fwd), \
            interp_launches
        interp_s = rec.fields['sample_s']
        sample = np.load(npy)
        assert sample.shape == (2, 4, R, R, R) and np.isfinite(sample).all()
        assert not (sample * (1 - m)).any(), 'interp sample is non-zero outside the grid mask'
        print(f'uncond_gen_interp (DDIM): {fwd} forwards at batch 2 in {interp_s:.3f} s, '
              f'{1000 * interp_s / fwd:.2f} ms per step; launches {interp_launches}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 12. training: main --mode train at full width, then checks on its state ----
    from meshdiffusion_tpu_torch.diffusion import losses
    from meshdiffusion_tpu_torch.utils.checkpoint import load_eval_weights
    tmp = tempfile.mkdtemp(prefix='chip_smoke_train_')
    try:
        grids = train_data(tmp, TetGrid.load(R).grid_mask())
        ops.reset_launch_counts()
        rec.train_logs.clear()
        state, tsteps, first, peak_run = train_run(port_main, os.path.join(tmp, 'meta.json'),
                                                   os.path.join(tmp, 'run'))
        train_launches = ops.launch_counts()
        n_micro = (TRAIN_STEPS + 1) * TRAIN_ITER
        assert train_launches == _launches(gn_affine=74 * n_micro, gn_silu_conv3d=74 * n_micro), \
            train_launches
        assert [t['step'] for t in tsteps] == list(range(TRAIN_STEPS + 1)), tsteps
        assert tsteps[0]['unchanged'] is True, 'step 0 moved the weights (lr 0 under warm-up)'
        model = state.model
        changed = sum(int((p != q).sum()) for p, q in zip(model.parameters(), first))
        n_weights = sum(p.numel() for p in model.parameters())
        assert changed > 0, 'the weights did not move over the run'
        del first
        logs = rec.train_logs
        assert [lg[0] for lg in logs] == [0, TRAIN_STEPS] and logs[-1][3] == TRAIN_STEPS and \
            all(np.isfinite(lg[1]) for lg in logs) and all(np.isfinite(t['loss']) for t in tsteps)
        assert {lg[5] for lg in logs} == {'native'}, logs
        foreign = sorted(m for m in sys.modules if m.split('.')[0] in (
            'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ml_collections', 'meshdiffusion_tpu',
            'tensorflow'))
        assert not foreign, f'the training run imported {foreign[:5]}'

        assert state.step == state.ema.num_updates == TRAIN_STEPS + 1, \
            (state.step, state.ema.num_updates)
        snap = os.path.join(tmp, 'run', 'checkpoints-meta', 'checkpoint.pth')
        eval_model = create_model(cfg, dev)
        assert load_eval_weights(snap, eval_model, cfg) == TRAIN_STEPS + 1
        for k, p in eval_model.named_parameters():
            assert torch.equal(p, state.ema.shadow[k]), k
        del eval_model
        snap_gib = os.path.getsize(snap) / 2 ** 30
        shutil.rmtree(os.path.join(tmp, 'run', 'checkpoints'), ignore_errors=True)
        # the trainer's own log: step 0 from the loop's start, then steps 1..TRAIN_STEPS
        # as it runs them (loader, pinned copy and step; the host waits at the last only)
        warm_s = logs[0][2]
        step_s = logs[-1][2] / logs[-1][3]
        dev_ms = [t['ms'] for t in tsteps[1:]]
        eff = TRAIN_MICRO * TRAIN_ITER
        load_ms = 1000 * logs[-1][4] / logs[-1][3]
        print(f'train: res64 full width, effective batch {eff} = {TRAIN_MICRO} x {TRAIN_ITER}, '
              f'dropout 0.1, bf16, remat on; step 0 (warm) {warm_s:.3f} s; steps 1-{TRAIN_STEPS} '
              f'by the trainer\'s log (loader and copy included): {step_s:.4f} s a step, '
              f'{1000 * step_s / eff:.2f} ms a sample; the step alone (CUDA events around each, '
              f'device span) {[round(t, 2) for t in dev_ms]} ms; losses '
              f'{[round(t["loss"], 5) for t in tsteps]}; '
              f'{changed} of {n_weights} weights moved by step {TRAIN_STEPS} (none by step 0); '
              f'native loader {load_ms:.2f} ms (host) a batch of {eff}, beside the card\'s work; '
              f'peak device memory of '
              f'the run {peak_run / 2 ** 30:.2f} GiB; preemption snapshot {snap_gib:.2f} GiB read '
              f'back, EMA bit-equal; no module of jax or the JAX package loaded; launches '
              f'{train_launches} (= 2 x 37 a micro-batch x {n_micro})')

        # one micro-batch step (forward, backward, Adam, EMA) under the profiler
        sde = VPSDE(beta_min=cfg.model.beta_min, beta_max=cfg.model.beta_max,
                    N=cfg.model.num_scales)
        step_fn = losses.make_train_step(sde, mask)
        batch = torch.from_numpy(np.ascontiguousarray(np.stack(
            [np.moveaxis(np.load(p), 0, -1) for p in grids[:TRAIN_MICRO]]))).to(dev)
        one = lambda: step_fn(state, batch[None])
        one_ms = _time_ms(one, 2, 1)
        prof = _device_ms(one, 1)
        fams = {}
        for k, t in prof.items():
            fams[_family(k)] = fams.get(_family(k), 0.0) + t
        busy = sum(prof.values())
        print(f'train: one step of one micro-batch of {TRAIN_MICRO} (forward, remat recompute, '
              f'backward, Adam, EMA; the step alone, no loader): {one_ms:.2f} ms (CUDA events), '
              f'device {busy:.2f} ms, the card busy {100 * busy / one_ms:.1f} %; device ms by family: '
              + ', '.join(f'{f} {t:.2f}' for f, t in sorted(fams.items(), key=lambda kv: -kv[1])))
        for k, t in sorted(prof.items(), key=lambda kv: -kv[1])[:15]:
            print(f'  {t:8.3f} ms  {k[:100]}')

        # the weight repacking an optimizer step causes: every Conv_0 that K3 reads
        convs = [m.Conv_0 for m in model.modules() if isinstance(m, ResnetBlockDDPM)]
        with torch.no_grad():
            for c in convs:
                c.weight.add_(0.0)          # a new version, as an Adam step leaves it
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in convs:
            c.packed()
        torch.cuda.synchronize()
        repack_ms = 1000 * (time.perf_counter() - t0)

        peak = {}
        for mb in (2, TRAIN_MICRO):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step_fn(state, batch[None, :mb])
            torch.cuda.synchronize()
            peak[mb] = torch.cuda.max_memory_allocated()
        slope = (peak[TRAIN_MICRO] - peak[2]) / (TRAIN_MICRO - 2)
        print(f'train: weight repacking after an optimizer step ({len(convs)} Conv_0 layouts) '
              f'{repack_ms:.2f} ms; peak device memory of a step (state included) at '
              f'micro-batch 2: {peak[2] / 2 ** 30:.2f} GiB, at {TRAIN_MICRO}: '
              f'{peak[TRAIN_MICRO] / 2 ** 30:.2f} GiB; {slope / 2 ** 30:.3f} GiB a sample, so '
              f'48 x 1 would need {(peak[2] + 46 * slope) / 2 ** 30:.1f} GiB')

        # kernels against the plain versions on the train path: micro-batch 2,
        # dropout 0 (both chains through K3), seeded normal(0, 0.02) weights
        with torch.no_grad():
            for p in model.parameters():
                p.normal_(0.0, 0.02, generator=g)
        for m in model.modules():
            if isinstance(m, ResnetBlockDDPM):
                m.dropout = 0.0
        sqrt_ac, sqrt_1m_ac = (torch.as_tensor(t, device=dev) for t in
                               (sde.sqrt_alphas_cumprod, sde.sqrt_1m_alphas_cumprod))
        labels2 = torch.tensor([100, 700], device=dev)
        noise2 = torch.randn(batch[:2].shape, device=dev, generator=g)
        got = []
        for scope in (contextlib.nullcontext, ops.plain):
            model.zero_grad(set_to_none=True)
            ops.reset_launch_counts()
            with scope():         # the backward too: it reruns the checkpointed blocks
                loss = losses.ddpm_loss(model, batch[:2], labels2, noise2, sqrt_ac, sqrt_1m_ac,
                                        mask, train=True)
                loss.backward()
            torch.cuda.synchronize()
            got.append((float(loss.detach()), ops.launch_counts()['gn_silu_conv3d'],
                        {k: p.grad for k, p in model.named_parameters() if p.grad is not None}))
        (lk, nk, gk), (lp, npl, gp) = got
        assert nk == 4 * 37 and npl == 0, (nk, npl)
        assert gk.keys() == gp.keys()
        loss_rel = abs(lk - lp) / abs(lp)
        flat = _rel_l2(torch.cat([gk[k].flatten() for k in gk]),
                       torch.cat([gp[k].flatten() for k in gk]))
        per = {k: _rel_l2(gk[k], gp[k]) for k in gk if float(gp[k].norm()) > 0}
        worst = max(per, key=per.get)
        assert np.isfinite(lk) and loss_rel <= 1e-4 and flat <= 2e-2, (lk, lp, loss_rel, flat)
        print(f'train: kernels against plain, micro-batch 2, dropout 0 ({nk} K3 launches: '
              f'both chains, forward and remat recompute): loss {lk:.6f} against {lp:.6f} '
              f'(relative error {loss_rel:.2e}, bound 1e-4); the flattened gradient relative L2 '
              f'{flat:.3e} (bound 2e-2); the worst tensor {worst} {per[worst]:.3e}')
        train_out = {'micro': TRAIN_MICRO, 'iter_size': TRAIN_ITER, 'warm_step_s': warm_s,
                     'step_s': step_s, 'ms_per_sample': 1000 * step_s / eff,
                     'step_device_span_ms': [t['ms'] for t in tsteps],
                     'losses': [t['loss'] for t in tsteps],
                     'loader_ms_per_batch': load_ms, 'peak_run_bytes': peak_run,
                     'micro_step_ms': one_ms, 'micro_step_device_ms': busy,
                     'busy_share': busy / one_ms, 'device_ms_by_family': fams,
                     'repack_ms': repack_ms, 'peak_bytes': {str(k): v for k, v in peak.items()},
                     'bytes_per_sample': slope, 'loss_rel_err': loss_rel, 'grad_rel_l2': flat,
                     'worst_tensor': [worst, per[worst]], 'launches': train_launches,
                     'card': _smi()}
        with open(os.path.join(out_dir, 'train.json'), 'w') as f:
            json.dump(train_out, f, indent=1)
        del state, model, got, gk, gp, batch
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 13-18: the data tools, res128 generation and extraction, the likelihood ----
    os.environ['XDG_CACHE_HOME'] = os.path.join(keep, 'cache')   # the 128 grid's cache
    tmp = tempfile.mkdtemp(prefix='chip_smoke_r128_')
    try:
        # ---- 13. the data tools on phase 7's fitted dict ----
        grid64, sample64, convert_s = data_tools_run(fitted, os.path.join(tmp, 'data'), dev)
        print(f'data tools: tets-to-3dgrid on the card ({convert_s:.3f} s for one dict) -> '
              f'{grid64}; its grid_to_tet gives back the dict\'s sdf sign and clipped deform '
              f'exactly; get-tet-mask bit-equal to TetGrid.load(64).grid_mask(); save-meta '
              f'lists it and the port\'s dataset reads it')
        # ---- 14. the 128 tet grid ----
        grid128 = grid128_run()
        # ---- 15. every kernel at the res128 shapes ----
        k128 = res128_kernels_run(dev, g, record, per_shape)
        # ---- 16. main --config res128 --mode uncond_gen, then extract ----
        mask128 = TetGrid.load(R128).grid_mask()
        gen128 = uncond128_run(port_main, rec, os.path.join(tmp, 'gen'), mask128, dev)
        uncond128_launches = gen128['launches']
        # ---- 17. a real shape on the 128 grid: extract --save_viz ----
        viz128 = viz128_run(port_main, rec, os.path.join(tmp, 'viz'), record, dev)
        viz_launches = viz128['launches']
        # ---- 18. the likelihood on the res64 model ----
        lk64 = likelihood_run(sample64, dev, g)
        likelihood_launches = lk64['launches']
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(keep, ignore_errors=True)
        os.environ.pop('XDG_CACHE_HOME', None)
    with open(os.path.join(out_dir, 'res128.json'), 'w') as f:
        json.dump({'data_tools_convert_s': convert_s, 'grid128': grid128, 'kernels': k128,
                   'uncond_gen': gen128, 'extract_viz': viz128, 'likelihood': lk64,
                   'card': _smi()}, f, indent=1)

    # ---- 19-20. the textured fit ----
    tex = textured_phases(port_main, rec, record, per_shape, dev)
    with open(os.path.join(out_dir, 'textured.json'), 'w') as f:
        json.dump({**tex['json'], 'card': _smi()}, f, indent=1)

    # ---- 21. the sharded modes of K3 and the statistics against their plain versions ----
    # at the shapes of phases 22 (res64, PAR_MICRO samples a rank, 2 and 4
    # slabs) and 23 (res128, 1 sample, 2 slabs), res128's captured on the meta device
    cfg128 = get_config('res128')
    with torch.device('meta'):
        model128 = get_model(cfg128.model.name).from_config(cfg128).eval()
        conv_calls128, _ = capture_conv_shapes(
            model128, torch.empty((1, R128, R128, R128, 4)), torch.full((1,), 500.0),
            torch.empty((1, R128, R128, R128, 1)))
    par_k = parallel_kernels_run([('res64', conv_calls, PAR_MICRO, (2, 4)),
                                  ('res128', conv_calls128, 1, (2,))], dev, g, record, per_shape)
    print(f'sharded modes at {len(par_k["rows"])} (shape, split) cases: K3 halo rel_l2 <= '
          f'{par_k["worst"]["halo_rel"]:.2e}, slabs together vs unsharded <= '
          f'{par_k["worst"]["cat_rel"]:.2e}, merged a/b vs gn_affine <= '
          f'{par_k["worst"]["ab_err"]:.1e}, moments vs plain <= '
          f'{par_k["worst"]["moments_err"]:.1e}')

    # ---- 22-23. training on rank meshes: every rank a process on this card, gloo ----
    # the ranks share the card with this process: drop the tet grids' device
    # tables it caches (the 128 grid's hold over a GiB), and let the ranks'
    # allocator grow its segments in place
    TetGrid.load.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    os.environ.setdefault('PYTORCH_CUDA_ALLOC_CONF', 'expandable_segments:True')
    print(f'before the ranks: this process holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB '
          f'({torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved)')
    tmp = tempfile.mkdtemp(prefix='chip_smoke_par_')
    par = {}
    try:
        mask64 = TetGrid.load(R).grid_mask()
        d64 = os.path.join(tmp, 'data64')
        os.makedirs(d64)
        train_data(d64, mask64)
        np.save(os.path.join(d64, 'mask.npy'), mask64)
        d128 = os.path.join(tmp, 'data128')
        os.makedirs(d128)
        mask128 = np.ones((R128,) * 3, np.float32)
        train_data(d128, mask128, n_grids=2, n_paths=2)
        np.save(os.path.join(d128, 'mask.npy'), mask128)
        cases = (('res64 (2, 2)', {'config': 'res64', 'world': 4, 'data': 2, 'spatial': 2,
                                   'global_micro': 2 * PAR_MICRO, 'iter_size': 2,
                                   'steps': PAR_STEPS, 'data_dir': d64, 'overrides': []}),
                 ('res128 (1, 2)', {'config': 'res128', 'world': 2, 'data': 1, 'spatial': 2,
                                    'global_micro': 1, 'iter_size': 1, 'steps': R128_PAR_STEPS,
                                    'data_dir': d128, 'overrides': []}))
        for name, spec in cases:
            spec.update(meta=os.path.join(spec['data_dir'], 'meta.json'),
                        mask=os.path.join(spec['data_dir'], 'mask.npy'),
                        dir=os.path.join(tmp, spec['config']))
            os.makedirs(spec['dir'])
            res = par[name] = parallel_train_run(spec, dev, 900)
            gib = lambda b: f'{b / 2 ** 30:.2f}'
            print(f'train {name}, {spec["world"]} ranks on one card (gloo), micro-batch '
                  f'{spec["global_micro"] // spec["data"]} a data row x iter_size '
                  f'{spec["iter_size"]}: the step on one global batch, all-reduced gradient vs '
                  f'one process rel_l2 {res["grad_rel_l2"]:.3e} (bound 1e-2), loss '
                  f'{res["loss"]:.6f} vs {res["loss_ref"]:.6f}; weights bit-equal on every rank; '
                  f'peak a rank {[gib(b) for b in res["step_peak"]]} GiB vs one process '
                  f'{gib(res["ref_peak"])} GiB; main --mode train steps 0-{spec["steps"]}: '
                  f'{res["s_per_step"]:.3f} s a step by the trainer\'s log (step 0 '
                  f'{res["warm_step_s"]:.2f} s), peak a rank {[gib(b) for b in res["train_peak"]]} '
                  f'GiB, gradient all-reduce {[round(t, 3) for t in res["train_all_reduce_s"][0]]} '
                  f's (rank 0); launches a rank a micro-batch {res["launches_rank0_per_micro"]}')
        nccl = nccl_shared_card_check(tmp)
        print(f'nccl, two ranks on one card: {nccl}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with open(os.path.join(out_dir, 'parallel.json'), 'w') as f:
        json.dump({'kernels': par_k, 'train': par, 'nccl_shared_card': nccl, 'card': _smi()}, f,
                  indent=1)

    # ---- 24. the edge-AA alternates at full width; the fit-quality gate ----
    tmp = tempfile.mkdtemp(prefix='chip_smoke_aa_')
    try:
        gt = os.path.join(tmp, 'gt.obj')
        gt_mesh(gt)
        aa = aa_alternates_run(gt, dev, record, per_shape)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for impl, r in aa.items():
        cmp = ('' if impl == 'compact' else
               f'; vs compact: image max-abs {r["img_max_abs_vs_compact"]:.3e} (bound 1e-5), '
               f'v_pos gradient rel_l2 {r["grad_rel_l2_vs_compact"]:.3e} (bound 1e-4)')
        print(f'AA {impl}: render {AA_RES[0]}^2 x{AA_BATCH}, 2 layers, capacities {r["caps"]}, '
              f'aa_overflow 0, tile_zmin {r["launches"]["tile_zmin"]} launch, bit-equal to '
              f'plain{cmp}')
    for impl, r in aa.items():
        a = r['aa']
        print(f'AA pass device time, {impl}: {a["calls"]} call(s) a render, forward '
              f'{a["fwd_device_ms"]:.4f} ms (CUDA events {a["fwd_events_ms"]:.4f}), forward + '
              f'backward {a["fwd_bwd_device_ms"]:.4f} ms (CUDA events '
              f'{a["fwd_bwd_events_ms"]:.4f})')
    gate = fit_quality_run(dev)
    with open(os.path.join(out_dir, 'aa_gate.json'), 'w') as f:
        json.dump({'aa_alternates': aa, **gate['json'], 'card': _smi()}, f, indent=1)

    # ---- 24b. the DiT-XL/4 preset: its attention kernel, a forward, uncond_gen ----
    dit = dit_run(port_main, dev, g, record, per_shape)

    # ---- 24c. the DiT-MoE-XL/4 preset: its expert kernels, a forward, uncond_gen ----
    moe = moe_run(port_main, dev, g, record, per_shape)

    # ---- 24d. the FLUX.1 preset: its attention mode and QK norm and RoPE kernel,
    # a forward, uncond_gen ----
    flux = flux_run(port_main, dev, g, record, per_shape)

    # ---- 25. results ----
    with open(os.path.join(out_dir, 'kernel_shapes.json'), 'w') as f:
        json.dump(per_shape, f, indent=1)
    meta = {
        'ancestral_update': ('triton', 'meshdiffusion_tpu_torch/ops/sampler_step.py',
                             'meshdiffusion_tpu/ops/sampler_step.py:52'),
        'gn_affine': ('cuda', 'meshdiffusion_tpu_torch/csrc/gn_stats.cu',
                      'meshdiffusion_tpu/ops/groupnorm.py:94'),
        'groupnorm_silu': ('triton', 'meshdiffusion_tpu_torch/ops/groupnorm.py',
                           'meshdiffusion_tpu/ops/groupnorm.py:94'),
        'gn_silu_conv3d': ('cuda', 'meshdiffusion_tpu_torch/csrc/gn_silu_conv3d.cu',
                           'meshdiffusion_tpu/ops/gn_silu_conv.py:142'),
        'tile_zmin': ('cuda', 'meshdiffusion_tpu_torch/csrc/tile_zmin.cu',
                      'meshdiffusion_tpu/ops/tile_raster.py:126'),
        'gn_silu_conv3d_halo': ('cuda', 'meshdiffusion_tpu_torch/csrc/gn_silu_conv3d.cu',
                                'meshdiffusion_tpu/ops/gn_silu_conv.py:142'),
        'gn_moments': ('cuda', 'meshdiffusion_tpu_torch/csrc/gn_stats.cu',
                       'meshdiffusion_tpu/ops/groupnorm.py:94'),
        'nin_residual': ('cuda', 'meshdiffusion_tpu_torch/csrc/nin_residual.cu',
                         'none: the plain NIN shortcut + residual sum of '
                         'meshdiffusion_tpu/models/layers.py:275-276'),
        'dit_attention': ('cuda', 'meshdiffusion_tpu_torch/csrc/dit_attention.cu',
                          'none: the DiT\'s multi-head attention (models/dit3d.py); the JAX '
                          'package has no transformer'),
        'moe_experts': ('cuda', 'meshdiffusion_tpu_torch/csrc/moe_experts.cu',
                        'none: the routed experts of DiT-MoE (models/moe.py); the JAX '
                        'package has no routed layer'),
        'qk_norm_rope': ('cuda', 'meshdiffusion_tpu_torch/csrc/qk_norm_rope.cu',
                         'none: FLUX\'s QKNorm and apply_rope (models/flux3d.py); the JAX '
                         'package has no transformer'),
    }
    by_path = {'uncond_gen': launches, 'fit_dmtets': fit_launches, 'fit_singleview': sv_launches,
               'cond_gen': cond_launches, 'uncond_gen_interp': interp_launches,
               'train': train_launches, 'uncond_gen_res128': uncond128_launches,
               'extract_viz': viz_launches, 'likelihood': likelihood_launches,
               'dit_uncond_gen': dit['launches'], 'ditmoe_uncond_gen': moe['launches'],
               'flux_uncond_gen': flux['launches'],
               **tex['launches'], 'train_res64_2x2': par['res64 (2, 2)']['launches'],
               'train_res128_1x2': par['res128 (1, 2)']['launches'],
               **{f'aa_alternates_{impl}': r['launches'] for impl, r in aa.items()},
               **gate['launches']}
    print(json.dumps({'launches_by_path': by_path}))
    path_launches = {n: sum(p[n] for p in by_path.values()) for n in launches}
    # launches a forward, a sampler step or a fit step (GT renders count as steps), all counted
    assert launches['ancestral_update'] % steps == 0, (launches, steps)
    assert fit_launches['tile_zmin'] % (FIT_POOL + steps_run) == 0, (fit_launches, steps_run)
    per_step = dict(per_fwd, ancestral_update=launches['ancestral_update'] // steps,
                    tile_zmin=fit_launches['tile_zmin'] // (FIT_POOL + steps_run))
    # the sharded modes: a rank's launches a res64 training micro-batch on the (2, 2) mesh
    per_step.update({n: par['res64 (2, 2)']['launches_rank0_per_micro'][n] for n in SHARDED})
    # the DiT's attention: a launch a block of a DiT forward
    per_step['dit_attention'] = 28
    per_fwd_dev['dit_attention'] = dit['device_ms_per_forward']
    # the routed experts: two launches a block of a DiT-MoE forward
    per_step['moe_experts'] = 56
    per_fwd_dev['moe_experts'] = moe['device_ms_per_forward']
    # the QK norm and RoPE: a launch a block of a FLUX forward (batch 4)
    per_step['qk_norm_rope'] = 30
    per_fwd_dev['qk_norm_rope'] = flux['qkrope_device_ms_per_forward']
    kernels = [{'name': n, 'route': route, 'source': src, 'replaces': rep,
                'launches': path_launches[n], 'launches_per_forward': per_step[n],
                'device_ms_per_forward': per_fwd_dev.get(n) or None, **results[n]}
               for n, (route, src, rep) in meta.items()]
    assert all(k['launches'] > 0 for k in kernels)
    print(json.dumps({'kernels': kernels}))
    print(_smi())
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
