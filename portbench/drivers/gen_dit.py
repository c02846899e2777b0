"""Driver ``gen_dit``: unconditional generation through the port's PC sampler
with the 3D diffusion transformer (``models/dit3d.py``) as the score
network.

The run is ``drivers/gen.py``'s with the DiT in the U-Net's place, and uses
its pieces as they are: the seeds (``seeds``), the checked steps
(``checked_steps``), the program's config tree (``port_config``), the
sampler's callbacks and trace window (``_Run``), and the traffic
parameters (``traffic/<mix>.json``, the same keys). The model is built as
``evaler.uncond_gen`` builds it: the program's grid mask, ``create_model``
with the benchmark's weights (``reference/dit.py``'s ``make_weights``)
loaded by ``load_state_dict``, and ``sampling.get_sampling_fn`` called as
``sampler(model_fn, noise)``.

What is checked is ``gen``'s: for each checked step k, the plain reference
(``reference/dit.py``, fp32, TF32 off, one sample at a time) recomputes eps
from the program's x_k (``eps_rel_l2``), the masked ancestral update is
recomputed from x_k, eps_k and z_k (``update_rel_err``), and the window's
first input must be the prior draw times the reference's mask
(``prior_max_abs``, exact). ``control`` puts the reference with fp8 e4m3
operands beside it, and the update in bf16.

A profiled window is complete when it recorded every launch of the
attention kernel (``depth`` a forward) and of ``ancestral_update`` (one a
step); its records keep, for each kernel, the host time of its launch
(matched by correlation id), which ``attn_share.dit`` reads against the
program's ``dit.attn`` spans.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from .. import harness
from ..counts import dit as dit_counts
from ..reference import dit as ref_dit, sde as ref_sde
from ..reference.unet import fp8_round
from .gen import (LayerCtx, _profiler_warmup, _Run, checked_steps, port_config, reference_mask,
                  seeds)

ATTN_KERNEL = 'dit_attention_kernel'
UPDATE_KERNEL = '_ancestral_kernel'


def launches(prof) -> List[tuple]:
    """[(kernel name, host start of its launch, device ns)] of a closed
    profiler's kernels, each matched to its launch record by correlation
    id."""
    from torch.autograd import DeviceType
    host, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.name(), e.correlation_id(), e.duration_ns()))
        elif 'Launch' in e.name():
            host[e.correlation_id()] = e.start_ns()
    return [(n, host[c], d) for n, c, d in dev if c in host]


class _DitRun(_Run):
    """``gen``'s callbacks; a window is complete when it holds every
    expected launch (kernel name -> launches a step), and a window it keeps
    carries its kernels' launch times (``window.launched``)."""

    def _complete(self, win) -> bool:
        return all(win.count((k,)) == n * win.steps for k, n in self.trace['expected'].items())

    def _trace_tick(self):
        prof, kept = self._prof, self.window
        super()._trace_tick()
        if prof is not None and self._prof is None and self.window is not kept:
            self.window.launched = launches(prof)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: bool = False) -> harness.Outcome:
    from meshdiffusion_tpu_torch.diffusion import evaler, sampling
    from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
    from meshdiffusion_tpu_torch.models import create_model

    cfg, tr = cell.config, cell.traffic
    B = tr['batch']
    config = port_config(cfg, B)
    a = ref_dit.arch(cfg)
    shape = (B, a['R'], a['R'], a['R'], a['C'])
    sd = seeds(seed)
    steps = checked_steps(tr, seed)
    walk = dit_counts.walk(a, B)

    # set-up: the program's mask and model, the benchmark's weights
    mask = torch.as_tensor(evaler.load_grid_mask(config), device=device)[None, ..., None]
    model = create_model(config, device).eval()
    flat, state = ref_dit.make_weights(a, sd['weights'], device)
    model.load_state_dict(state, strict=True)
    del flat, state
    if device.type == 'cuda':
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    sde = VPSDE(beta_min=config.model.beta_min, beta_max=config.model.beta_max,
                N=config.model.num_scales)
    sampler = sampling.get_sampling_fn(config, sde, shape, eps=1e-3, grid_mask=mask)
    tcfg = (dict(tr, expected={ATTN_KERNEL: a['depth'], UPDATE_KERNEL: 1}) if trace else None)
    runner = _DitRun(model, mask, shape, device, sd['noise'], steps, tcfg)
    runner.drive(sampler, 'warmup', steps=tr['warmup_steps'])
    if trace:
        _profiler_warmup(device)
    setup_s = time.perf_counter() - t_start

    # the window
    t0 = time.perf_counter()
    runner.drive(sampler, 'window', seconds=seconds)
    window_s = time.perf_counter() - t0
    n_steps = runner.steps
    peak = torch.cuda.max_memory_allocated(device) if device.type == 'cuda' else 0
    chain_i, caps, got, win = runner.chain_i, runner.cap, runner.got, runner.window
    traced_s, traced_steps = runner.traced_s, runner.traced_steps
    del runner, sampler, model, mask
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    measured = {'ms_per_sample_step': window_s * 1e3 / (n_steps * B), 'setup_s': setup_s}
    checks, bad = compare(cell, a, sd['weights'], steps, chain_i, caps, got, device, control)
    ctx = None
    if trace:
        ctx = LayerCtx(win, walk, (window_s - traced_s) / (n_steps - traced_steps))
    return harness.Outcome(measured=measured, checks=checks, attempted=n_steps * B,
                           failed=bad, memory_peak_bytes=int(peak), layer_ctx=ctx)


def compare(cell, a: dict, weight_seed: int, steps: List[int], chain_i: Dict[int, int],
            caps: dict, got: set, device, control: bool = False):
    """The checks of the captured steps against the plain reference, as
    ``gen.compare`` makes them for the U-Net. Every reading goes to
    ``cell.readings``, with ``control`` the control's too. Returns (checks,
    failed sample-steps)."""
    lim = cell.limits
    missing = [k for k in caps if k not in got]
    if missing:
        cell.readings = {}
        return [harness.Check('steps_captured', float(len(missing)), 0.0)], len(steps)
    m = cell.config['model']
    sched = ref_sde.Schedule(m['beta_min'], m['beta_max'], m['num_scales'])
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    readings = {'eps_rel_l2': [], 'update_rel_err': [], 'ctrl_eps_rel_l2': [],
                'ctrl_update_rel_err': []}
    try:
        mask = reference_mask(cell.config, device)
        _, p = ref_dit.make_weights(a, weight_seed, device)

        def dev(key):
            return caps[key].to(device)
        prior = float((dev(('x', 0)) - dev(('prior', 0)) * mask[None, ..., None]).abs().max())
        bad = set()
        with torch.no_grad():
            for k in steps:
                label, beta, std = sched.step(chain_i[k])
                x, eps, z, x1 = (dev((w, kk)) for w, kk in
                                 (('x', k), ('eps', k), ('z', k), ('x', k + 1)))
                for b in range(x.shape[0]):
                    lab = torch.full((1,), label, device=device)
                    ref = ref_dit.forward(p, a, x[b:b + 1], lab, mask)
                    e = float((eps[b:b + 1] - ref).norm() / ref.norm())
                    readings['eps_rel_l2'].append(e)
                    if e > lim['eps_rel_l2']:
                        bad.add((k, b))
                    if control:
                        ctl = ref_dit.forward(p, a, x[b:b + 1], lab, mask, q=fp8_round)
                        readings['ctrl_eps_rel_l2'].append(float((ctl - ref).norm() / ref.norm()))
                        del ctl
                    del ref
                mk = mask[None, ..., None]
                x1_ref = ref_sde.ancestral_update(x, eps, z, mk, beta, std)
                u = float((x1 - x1_ref).abs().max() / x1_ref.abs().max())
                readings['update_rel_err'].append(u)
                if u > lim['update_rel_err']:
                    bad.update((k, b) for b in range(x.shape[0]))
                if control:
                    x1_ctl = ref_sde.ancestral_update(x, eps, z, mk, beta, std, torch.bfloat16)
                    readings['ctrl_update_rel_err'].append(
                        float((x1_ctl - x1_ref).abs().max() / x1_ref.abs().max()))
                del x, eps, z, x1, x1_ref
        del p, mask
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        if device.type == 'cuda':
            torch.cuda.empty_cache()
    cell.readings = readings
    checks = [harness.Check('prior_max_abs', prior, lim['prior_max_abs']),
              harness.Check('eps_rel_l2', max(readings['eps_rel_l2']), lim['eps_rel_l2']),
              harness.Check('update_rel_err', max(readings['update_rel_err']),
                            lim['update_rel_err'])]
    return checks, len(bad) + (0 if prior <= lim['prior_max_abs'] else 1)
