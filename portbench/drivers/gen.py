"""Driver ``gen``: unconditional generation through the port's PC sampler.

Built as ``meshdiffusion_tpu_torch.diffusion.evaler.uncond_gen`` builds it:
the program's grid mask (``evaler.load_grid_mask``), ``create_model`` with
the benchmark's weights loaded by ``load_state_dict``, and
``sampling.get_sampling_fn(config, sde, shape, eps=1e-3, grid_mask=mask)``
called as ``sampler(model_fn, noise)``. Chains run one after another from
fresh priors. The noise source is the benchmark's own (a CUDA generator
seeded from ``--seed``); each ``'predictor'`` draw starts one sampler step,
so the draws count the steps, and the first draw past the deadline ends
the window. ``model_fn`` and the draws run inside ``portbench.unet`` and
``portbench.noise`` spans.

Traffic parameters (``traffic/<mix>.json``): ``batch``; ``warmup_steps``,
the steps run in set-up; ``check_steps``, how many steps besides the
window's first are checked, drawn from the seed among the window's first
``check_within``; ``trace_at`` and ``trace_steps``, where the profiler
window of a ``--trace 1`` run starts and how many steps it covers, and
``trace_tries``, how many such windows may be taken until one recorded
every kernel launch.

What is checked, after the window, the program's state freed and its
memory peak read: for each checked step k, the program's U-Net input x_k,
its output eps_k, the step's noise z_k and the next input x_{k+1} (copied
to the host as the step runs). The plain reference (``reference/``) works
out the grid mask and the schedule itself, takes the same weights (made
again from the seed) and recomputes eps from x_k in fp32 with TF32 off
(``eps_rel_l2``: the largest per-sample relative L2 gap), and the masked
ancestral update from x_k, eps_k and z_k (``update_rel_err``: the largest
gap over the largest |x_{k+1}|). The reference follows the program from
its own state x_k; the start it skips is checked by itself: the window's
first input must equal the prior draw times the reference's mask
(``prior_max_abs``, exact).
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .. import harness, trace as trace_mod, weights
from ..counts import unet as unet_counts
from ..reference import gridmask, sde as ref_sde, unet as ref_unet


class _WindowEnd(Exception):
    """Raised from the noise source at the draw that ends a phase."""


def seeds(seed: int) -> Dict[str, int]:
    """Independent 63-bit seeds for the weights, the noise and the check."""
    w, n, c = np.random.SeedSequence(seed).generate_state(3, dtype=np.uint64)
    return {'weights': int(w) >> 1, 'noise': int(n) >> 1, 'check': int(c) >> 1}


def checked_steps(traffic: dict, seed: int) -> List[int]:
    """The window's first step and ``check_steps`` others drawn from the
    seed among its first ``check_within``."""
    rng = np.random.default_rng(seeds(seed)['check'])
    more = rng.choice(np.arange(1, traffic['check_within']), traffic['check_steps'],
                      replace=False)
    return sorted({0, *map(int, more)})


def port_config(cfg: dict, batch: int):
    """The program's config tree: the preset with every value of the
    configuration file's sections set over it."""
    from meshdiffusion_tpu_torch.config import get_config
    config = get_config(cfg['preset'])
    for sec in ('model', 'data', 'sampling', 'eval', 'gpu'):
        for k, v in cfg.get(sec, {}).items():
            config[sec][k] = tuple(v) if isinstance(v, list) else v
    config.eval.batch_size = batch
    return config


class _Run:
    """The sampler's callbacks: step counting, deadline, captures, trace."""

    def __init__(self, model, mask, shape, device, noise_seed: int, steps: List[int],
                 trace: Optional[dict]):
        self.model, self.mask, self.device = model, mask, device
        self.gen = torch.Generator(device=device).manual_seed(noise_seed)
        self.phase, self.limit, self.deadline = 'warmup', 0, 0.0
        self.steps = 0                       # predictor draws that returned in this phase
        self.chain_i: Dict[int, int] = {}    # window step -> the chain's step index

        def buf():
            return torch.empty(shape, dtype=torch.float32, pin_memory=device.type == 'cuda')
        self.cap = {('prior', 0): buf()}
        for k in steps:
            for what in ('x', 'eps', 'z'):
                self.cap[(what, k)] = buf()
            self.cap[('x', k + 1)] = buf()
        self.got = set()
        self.trace = trace
        self.window: Optional[trace_mod.Window] = None
        self.trace_next = trace['trace_at'] if trace else None
        self.trace_tries = trace['trace_tries'] if trace else 0
        self._prof, self._sub_t0 = None, 0.0
        self.traced_s, self.traced_steps = 0.0, 0     # host time and steps under the profiler

    def _copy(self, key, t):
        if self.phase == 'window' and key in self.cap and key not in self.got:
            self.cap[key].copy_(t, non_blocking=True)
            self.got.add(key)

    # -- the trace window ------------------------------------------------------------
    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _trace_tick(self):
        if self.trace_next is None or self.steps != self.trace_next:
            return
        if self._prof is None:
            self._sub_t0 = time.perf_counter()
            self._sync()
            self._prof = profile(activities=_activities(self.device))
            self._prof.__enter__()
            self.trace_next = self.steps + self.trace['trace_steps']
            return
        self._sync()
        self._prof.__exit__(None, None, None)
        win = trace_mod.Window(self._prof, self.trace['trace_steps'])
        self._prof = None
        self.traced_s += time.perf_counter() - self._sub_t0
        self.traced_steps += self.trace['trace_steps']
        self.trace_tries -= 1
        complete = self._complete(win)
        if self.window is None or complete:
            self.window = win
        done = complete or self.trace_tries <= 0
        self.trace_next = None if done else self.steps + self.trace['trace_steps']

    def _complete(self, win) -> bool:
        exp = self.trace['expected']
        return all(win.count(trace_mod.OWN_KERNELS[k]) == n * win.steps for k, n in exp.items())

    # -- the sampler's callbacks -------------------------------------------------------
    def noise(self, name, shape, i=-1, j=0):
        if name == 'predictor':
            if self.phase == 'warmup' and self.steps >= self.limit:
                raise _WindowEnd
            if self.phase == 'window':
                # a traced run's window lasts until its profiled steps are in
                if time.perf_counter() >= self.deadline and self.trace_next is None:
                    raise _WindowEnd
                self._trace_tick()
                self.chain_i[self.steps] = i
            self.steps += 1
        with record_function('portbench.noise'):
            z = torch.randn(shape, generator=self.gen, device=self.device)
        if name == 'prior':
            self._copy(('prior', 0), z)
        elif name == 'predictor':
            self._copy(('z', self.steps - 1), z)
        return z

    def model_fn(self, x, labels):
        k = self.steps - 1
        self._copy(('x', k), x)
        with record_function('portbench.unet'):
            eps = self.model(x, labels, self.mask)
        self._copy(('eps', k), eps)
        return eps

    def drive(self, sampler, phase: str, seconds: float = 0.0, steps: int = 0) -> None:
        """Run chains until the phase's end: ``steps`` draws in warm-up, the
        first draw past ``seconds`` in the window."""
        self.phase, self.steps, self.limit = phase, 0, steps
        self.deadline = time.perf_counter() + seconds
        with torch.inference_mode():
            while True:
                try:
                    sampler(self.model_fn, self.noise)
                except _WindowEnd:
                    break
        self._sync()


def _activities(device):
    """The profiler's CUDA activity alone (host ops recorded as well would
    slow a host-bound step); the CPU's where the run has no card."""
    return [ProfilerActivity.CUDA if device.type == 'cuda' else ProfilerActivity.CPU]


def _profiler_warmup(device) -> None:
    """Start and stop the profiler once in set-up, so that its first start
    (CUPTI's) is not paid inside the window."""
    with profile(activities=_activities(device)):
        torch.ones(8, device=device).sum()
        if device.type == 'cuda':
            torch.cuda.synchronize(device)


def _expected(walk: dict) -> Dict[str, int]:
    return {'gn_silu_conv3d': len(walk['k3']), 'gn_stats': len(walk['gn_stats']),
            'ancestral_update': 1}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: bool = False) -> harness.Outcome:
    from meshdiffusion_tpu_torch.diffusion import evaler, sampling
    from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
    from meshdiffusion_tpu_torch.models import create_model

    cfg, tr = cell.config, cell.traffic
    B = tr['batch']
    config = port_config(cfg, B)
    a = ref_unet.arch(cfg)
    R, C = a['R'], a['C']
    shape = (B, R, R, R, C)
    sd = seeds(seed)
    steps = checked_steps(tr, seed)
    walk = unet_counts.walk(a, B)

    # set-up: the program's mask and model, the benchmark's weights
    mask = torch.as_tensor(evaler.load_grid_mask(config), device=device)[None, ..., None]
    model = create_model(config, device).eval()
    flat, state = weights.make(a, sd['weights'], device)
    model.load_state_dict(state, strict=True)
    del flat, state
    if device.type == 'cuda':
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    sde = VPSDE(beta_min=config.model.beta_min, beta_max=config.model.beta_max,
                N=config.model.num_scales)
    sampler = sampling.get_sampling_fn(config, sde, shape, eps=1e-3, grid_mask=mask)
    tcfg = dict(tr, expected=_expected(walk)) if trace else None
    runner = _Run(model, mask, shape, device, sd['noise'], steps, tcfg)
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
    chain_i = runner.chain_i
    runner_traced = (runner.traced_s, runner.traced_steps)
    caps, got = runner.cap, runner.got
    win = runner.window
    del runner, sampler, model, mask
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    measured = {'ms_per_sample_step': window_s * 1e3 / (n_steps * B), 'setup_s': setup_s,
                'peak_mem_gib': peak / 2 ** 30}
    checks, bad = compare(cell, a, sd['weights'], steps, chain_i, caps, got, device, control)
    ctx = None
    if trace:
        step_s = (window_s - runner_traced[0]) / (n_steps - runner_traced[1])
        ctx = LayerCtx(win, walk, step_s)
    return harness.Outcome(measured=measured, checks=checks, attempted=n_steps * B,
                           failed=bad, memory_peak_bytes=int(peak), layer_ctx=ctx)


class LayerCtx:
    """What the per-layer readers of a generation cell read: the profiled
    window, the forward's frozen counts (``walk``), the profiled window's
    step count, and ``step_s``, the host clock's seconds a step over the rest
    of the run's window (the steps the profiler did not slow)."""

    def __init__(self, window, walk: dict, step_s: float):
        self.window, self.walk, self.step_s = window, walk, step_s
        self.forwards = window.steps


def reference_mask(cfg: dict, device) -> torch.Tensor:
    R = cfg['data']['image_size']
    tet = cfg.get('tet_file', '')
    if tet:
        tet = os.path.join(harness.ROOT, tet)
    return torch.as_tensor(gridmask.load(R, tet), device=device)


def compare(cell, a: dict, weight_seed: int, steps: List[int], chain_i: Dict[int, int],
            caps: dict, got: set, device, control: bool = False):
    """The checks of the captured steps against the plain reference. Every
    reading goes to ``cell.readings``, with ``control`` the control's too.
    Returns (checks, failed sample-steps)."""
    lim = cell.limits
    missing = [k for k in caps if k not in got]
    if missing:
        cell.readings = {}
        return [harness.Check('steps_captured', float(len(missing)), 0.0)], len(steps)
    cfg = cell.config
    m = cfg['model']
    sched = ref_sde.Schedule(m['beta_min'], m['beta_max'], m['num_scales'])
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    readings = {'eps_rel_l2': [], 'update_rel_err': [], 'ctrl_eps_rel_l2': [],
                'ctrl_update_rel_err': []}
    try:
        mask = reference_mask(cfg, device)
        _, p = weights.make(a, weight_seed, device)

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
                    xb = x[b:b + 1].permute(0, 4, 1, 2, 3)
                    lab = torch.full((1,), label, device=device)
                    ref = ref_unet.forward(p, a, xb, lab, mask).permute(0, 2, 3, 4, 1)
                    e = float((eps[b:b + 1] - ref).norm() / ref.norm())
                    readings['eps_rel_l2'].append(e)
                    if e > lim['eps_rel_l2']:
                        bad.add((k, b))
                    if control:
                        ctl = ref_unet.forward(p, a, xb, lab, mask, q=ref_unet.fp8_round)
                        readings['ctrl_eps_rel_l2'].append(
                            float((ctl.permute(0, 2, 3, 4, 1) - ref).norm() / ref.norm()))
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
