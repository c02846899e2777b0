"""Driver ``gen_dit_moe``: unconditional generation through the port's PC
sampler with the sparse-expert DiT (``models/dit3d.py`` with
``models/moe.py``, DiT-MoE's block) as the score network.

The run is ``drivers/gen_dit.py``'s, with its pieces and ``gen``'s used as
they are (seeds, checked steps, the program's config tree, the sampler's
callbacks, the trace window and its launch times), the model built as
``evaler.uncond_gen`` builds it, and the benchmark's weights
(``reference/dit_moe.py``'s ``make_weights``) loaded by ``load_state_dict``.
A profiled window is complete when it recorded every launch of the
attention kernel, of both expert kernels (``depth`` each a forward) and of
``ancestral_update`` (one a step).

What is checked: ``gen``'s numbers, and the routes. At each checked step
the program's own top-2 expert ids of every token and block are taken
from the timed forward itself, through the model's capture switch
(``capture_routes``), which the driver turns on for that forward alone.
The plain reference (``reference/dit_moe.py``, fp32, TF32 off, one sample
at a time) follows the program from its captured x_k with those routes, at
its own probabilities: ``eps_rel_l2`` holds the program's arithmetic,
whatever the routing. The routes are held apart, to the reference's own
top 2 at each (token, block): ``route_disagree`` is the largest share, over
the checked samples, of the pairs whose top-2 set differs, and
``route_flip_gap`` the largest gap between the reference's 2nd and 3rd
probability at such a pair, so that every flip lies at a near-tie. Then
``update_rel_err`` and ``prior_max_abs`` as ``gen``. ``control`` runs the
reference with fp8 e4m3 operands in every product (the router's and the
experts' too) with its own routes, beside the reference following them, and
the update in bf16.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from .. import harness
from ..counts import dit_moe as moe_counts
from ..reference import dit_moe as ref_moe, sde as ref_sde
from ..reference.unet import fp8_round
from .gen import LayerCtx, _profiler_warmup, checked_steps, port_config, reference_mask, seeds
from .gen_dit import ATTN_KERNEL, UPDATE_KERNEL, _DitRun

GATE_UP_KERNEL = 'moe_gate_up_kernel'
DOWN_KERNEL = 'moe_down_kernel'


class _MoeRun(_DitRun):
    """``gen_dit``'s callbacks, and at each checked step the timed forward's
    routes, (depth, B T, k) int64, copied to the host as x and eps are."""

    def __init__(self, model, mask, shape, device, noise_seed, steps, trace, routes_shape):
        super().__init__(model, mask, shape, device, noise_seed, steps, trace)
        for k in steps:
            self.cap[('routes', k)] = torch.empty(routes_shape, dtype=torch.int64,
                                                  pin_memory=device.type == 'cuda')

    def model_fn(self, x, labels):
        key = ('routes', self.steps - 1)
        if self.phase != 'window' or key not in self.cap or key in self.got:
            return super().model_fn(x, labels)
        sink: List[torch.Tensor] = []
        self.model.capture_routes(sink)
        try:
            eps = super().model_fn(x, labels)
        finally:
            self.model.capture_routes(None)
        self._copy(key, torch.stack(sink))
        return eps


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: bool = False) -> harness.Outcome:
    cfg, tr = cell.config, cell.traffic
    B = tr['batch']
    config = port_config(cfg, B)          # a program without the preset stops here

    from meshdiffusion_tpu_torch.diffusion import evaler, sampling
    from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
    from meshdiffusion_tpu_torch.models import create_model
    a = ref_moe.arch(cfg)
    shape = (B, a['R'], a['R'], a['R'], a['C'])
    T = (a['R'] // a['p']) ** 3
    sd = seeds(seed)
    steps = checked_steps(tr, seed)
    walk = moe_counts.walk(a, B)

    # set-up: the program's mask and model, the benchmark's weights
    mask = torch.as_tensor(evaler.load_grid_mask(config), device=device)[None, ..., None]
    model = create_model(config, device).eval()
    flat, state = ref_moe.make_weights(a, sd['weights'], device)
    model.load_state_dict(state, strict=True)
    del flat, state
    if device.type == 'cuda':
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    sde = VPSDE(beta_min=config.model.beta_min, beta_max=config.model.beta_max,
                N=config.model.num_scales)
    sampler = sampling.get_sampling_fn(config, sde, shape, eps=1e-3, grid_mask=mask)
    expected = {ATTN_KERNEL: a['depth'], GATE_UP_KERNEL: a['depth'], DOWN_KERNEL: a['depth'],
                UPDATE_KERNEL: 1}
    tcfg = dict(tr, expected=expected) if trace else None
    runner = _MoeRun(model, mask, shape, device, sd['noise'], steps, tcfg,
                     (a['depth'], B * T, a['k']))
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


def route_readings(got: List[torch.Tensor], own: List[torch.Tensor],
                   gap: List[torch.Tensor]):
    """(share of the (token, block) pairs whose top-k set in ``got`` differs
    from ``own``, the largest ``gap`` at such a pair, 0 where none)."""
    flips, worst, n = 0, 0.0, 0
    for g, o, d in zip(got, own, gap):
        diff = (g.to(o.device).sort(dim=1).values != o.sort(dim=1).values).any(dim=1)
        flips += int(diff.sum())
        n += diff.numel()
        if diff.any():
            worst = max(worst, float(d[diff].max()))
    return flips / n, worst


def compare(cell, a: dict, weight_seed: int, steps: List[int], chain_i: Dict[int, int],
            caps: dict, got: set, device, control: bool = False):
    """The checks of the captured steps against the plain reference (module
    docstring). Every reading goes to ``cell.readings``, with ``control``
    the control's too. Returns (checks, failed sample-steps)."""
    lim = cell.limits
    missing = [k for k in caps if k not in got]
    if missing:
        cell.readings = {}
        return [harness.Check('steps_captured', float(len(missing)), 0.0)], len(steps)
    m = cell.config['model']
    sched = ref_sde.Schedule(m['beta_min'], m['beta_max'], m['num_scales'])
    T = (a['R'] // a['p']) ** 3
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    names = ('eps_rel_l2', 'route_disagree', 'route_flip_gap', 'update_rel_err')
    readings = {k: [] for k in names + tuple('ctrl_' + n for n in names)}
    try:
        mask = reference_mask(cell.config, device)
        _, p = ref_moe.make_weights(a, weight_seed, device)

        def dev(key):
            return caps[key].to(device)
        prior = float((dev(('x', 0)) - dev(('prior', 0)) * mask[None, ..., None]).abs().max())
        bad = set()
        with torch.no_grad():
            for k in steps:
                label, beta, std = sched.step(chain_i[k])
                x, eps, z, x1, routes = (dev((w, kk)) for w, kk in
                                         (('x', k), ('eps', k), ('z', k), ('x', k + 1),
                                          ('routes', k)))
                for b in range(x.shape[0]):
                    lab = torch.full((1,), label, device=device)
                    mine = list(routes[:, b * T:(b + 1) * T])
                    ref, info = ref_moe.forward(p, a, x[b:b + 1], lab, mask, routes=mine)
                    e = float((eps[b:b + 1] - ref).norm() / ref.norm())
                    share, gap = route_readings(mine, info['top'], info['gap'])
                    for n, v in zip(names, (e, share, gap)):
                        readings[n].append(v)
                        if v > lim[n]:
                            bad.add((k, b))
                    del ref, info
                    if control:
                        ctl, ctl_info = ref_moe.forward(p, a, x[b:b + 1], lab, mask, q=fp8_round)
                        ref, info = ref_moe.forward(p, a, x[b:b + 1], lab, mask,
                                                    routes=ctl_info['top'])
                        readings['ctrl_eps_rel_l2'].append(float((ctl - ref).norm() / ref.norm()))
                        share, gap = route_readings(ctl_info['top'], info['top'], info['gap'])
                        readings['ctrl_route_disagree'].append(share)
                        readings['ctrl_route_flip_gap'].append(gap)
                        del ctl, ctl_info, ref, info
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
                del x, eps, z, x1, x1_ref, routes
        del p, mask
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        if device.type == 'cuda':
            torch.cuda.empty_cache()
    cell.readings = readings
    checks = [harness.Check('prior_max_abs', prior, lim['prior_max_abs'])]
    checks += [harness.Check(n, max(readings[n]), lim[n]) for n in names]
    return checks, len(bad) + (0 if prior <= lim['prior_max_abs'] else 1)
