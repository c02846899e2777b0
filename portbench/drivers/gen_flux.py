"""Driver ``gen_flux``: text-conditioned generation through the port's PC
sampler with FLUX.1's MMDiT (``models/flux3d.py``) as the score network.

The run is ``drivers/gen_dit.py``'s, with its pieces and ``gen``'s used as
they are (seeds, checked steps, the program's config tree, the sampler's
callbacks, the trace window and its launch times), the model built as
``evaler.uncond_gen`` builds it, and the benchmark's weights
(``reference/flux.py``'s ``make_weights``) loaded by ``load_state_dict``;
the weights' buffer is freed before the window. Each chain has its own
condition, drawn from the noise generator at the chain's prior draw and
kept fixed along it: ``txt`` (B, context_len, context_in_dim) and ``y``
(B, vec_in_dim) standard normal (the T5 and CLIP features that no encoder
here makes), and ``guidance`` (B,) at the traffic's ``guidance``. The
sampler's model function passes them to the model at every step, as the
program's ``evaler`` passes its condition.

A profiled window is complete when it recorded every launch of the dh-128
attention kernel and of the QK norm and RoPE kernel (one each a block,
``depth`` + ``depth_single_blocks`` a forward) and of ``ancestral_update``
(one a step).

What is checked is ``gen``'s: for each checked step k, the plain reference
(``reference/flux.py``, fp32, TF32 off, one sample at a time) recomputes
eps from the program's x_k with the chain's own txt, y and guidance
(captured with x_k) (``eps_rel_l2``); the masked ancestral update from x_k,
eps_k and z_k (``update_rel_err``); the window's first input against the
prior draw times the reference's mask (``prior_max_abs``, exact). The
reference draws its weights again from the seed after the program's model
is freed, so that the card never holds two models and a weight buffer.
``control`` puts the reference with fp8 e4m3 operands beside it, and the
update in bf16.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from .. import harness
from ..counts import flux as flux_counts
from ..reference import flux as ref_flux, sde as ref_sde
from ..reference.unet import fp8_round
from .gen import LayerCtx, _profiler_warmup, checked_steps, port_config, reference_mask, seeds
from .gen_dit import UPDATE_KERNEL, _DitRun

ATTN_KERNEL = 'dit_attention_dh128_kernel'
QKROPE_KERNEL = 'qk_norm_rope_kernel'


class _FluxRun(_DitRun):
    """``gen_dit``'s callbacks, a condition a chain, and at each checked step
    the chain's txt and y, copied to the host as x and eps are."""

    def __init__(self, model, mask, shape, device, noise_seed, steps, trace, a: dict,
                 guidance: float):
        super().__init__(model, mask, shape, device, noise_seed, steps, trace)
        B = shape[0]
        self.cond_shapes = {'txt': (B, a['ctx_len'], a['ctx']), 'y': (B, a['vec'])}
        self.guidance = torch.full((B,), float(guidance), device=device)
        self.cond = None
        for k in steps:
            for what, s in self.cond_shapes.items():
                self.cap[(what, k)] = torch.empty(s, dtype=torch.float32,
                                                  pin_memory=device.type == 'cuda')

    def noise(self, name, shape, i=-1, j=0):
        z = super().noise(name, shape, i, j)
        if name == 'prior':
            with record_function('portbench.noise'):
                self.cond = {w: torch.randn(s, generator=self.gen, device=self.device)
                             for w, s in self.cond_shapes.items()}
                self.cond['guidance'] = self.guidance
        return z

    def model_fn(self, x, labels):
        k = self.steps - 1
        for what in self.cond_shapes:
            self._copy((what, k), self.cond[what])
        self._copy(('x', k), x)
        with record_function('portbench.unet'):
            eps = self.model(x, labels, self.mask, **self.cond)
        self._copy(('eps', k), eps)
        return eps


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: bool = False) -> harness.Outcome:
    cfg, tr = cell.config, cell.traffic
    B = tr['batch']
    config = port_config(cfg, B)          # a program without the preset stops here

    from meshdiffusion_tpu_torch.diffusion import evaler, sampling
    from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
    from meshdiffusion_tpu_torch.models import create_model
    a = ref_flux.arch(cfg)
    shape = (B, a['R'], a['R'], a['R'], a['C'])
    sd = seeds(seed)
    steps = checked_steps(tr, seed)
    walk = flux_counts.walk(a, B)

    # set-up: the program's mask and model, the benchmark's weights
    mask = torch.as_tensor(evaler.load_grid_mask(config), device=device)[None, ..., None]
    model = create_model(config, device).eval()
    flat, state = ref_flux.make_weights(a, sd['weights'], device)
    model.load_state_dict(state, strict=True)
    del flat, state
    if device.type == 'cuda':
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    sde = VPSDE(beta_min=config.model.beta_min, beta_max=config.model.beta_max,
                N=config.model.num_scales)
    sampler = sampling.get_sampling_fn(config, sde, shape, eps=1e-3, grid_mask=mask)
    blocks = a['depth'] + a['single']
    expected = {ATTN_KERNEL: blocks, QKROPE_KERNEL: blocks, UPDATE_KERNEL: 1}
    tcfg = dict(tr, expected=expected) if trace else None
    runner = _FluxRun(model, mask, shape, device, sd['noise'], steps, tcfg, a, tr['guidance'])
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
    checks, bad = compare(cell, a, sd['weights'], steps, chain_i, caps, got, device,
                          tr['guidance'], control)
    ctx = None
    if trace:
        ctx = LayerCtx(win, walk, (window_s - traced_s) / (n_steps - traced_steps))
    return harness.Outcome(measured=measured, checks=checks, attempted=n_steps * B,
                           failed=bad, memory_peak_bytes=int(peak), layer_ctx=ctx)


def compare(cell, a: dict, weight_seed: int, steps: List[int], chain_i: Dict[int, int],
            caps: dict, got: set, device, guidance: float, control: bool = False):
    """The checks of the captured steps against the plain reference, as
    ``gen.compare`` makes them for the U-Net, each sample with its chain's
    condition. Every reading goes to ``cell.readings``, with ``control`` the
    control's too. Returns (checks, failed sample-steps)."""
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
        _, p = ref_flux.make_weights(a, weight_seed, device)

        def dev(key):
            return caps[key].to(device)
        prior = float((dev(('x', 0)) - dev(('prior', 0)) * mask[None, ..., None]).abs().max())
        bad = set()
        with torch.no_grad():
            for k in steps:
                label, beta, std = sched.step(chain_i[k])
                x, eps, z, x1, txt, y = (dev((w, kk)) for w, kk in
                                         (('x', k), ('eps', k), ('z', k), ('x', k + 1),
                                          ('txt', k), ('y', k)))
                for b in range(x.shape[0]):
                    lab = torch.full((1,), label, device=device)
                    g = torch.full((1,), float(guidance), device=device)
                    cond = (txt[b:b + 1], y[b:b + 1], g)
                    ref = ref_flux.forward(p, a, x[b:b + 1], lab, mask, *cond)
                    e = float((eps[b:b + 1] - ref).norm() / ref.norm())
                    readings['eps_rel_l2'].append(e)
                    if e > lim['eps_rel_l2']:
                        bad.add((k, b))
                    if control:
                        ctl = ref_flux.forward(p, a, x[b:b + 1], lab, mask, *cond, q=fp8_round)
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
                del x, eps, z, x1, x1_ref, txt, y
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
