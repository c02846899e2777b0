"""The port's training math against the JAX package, on the CPU in float32.

At the tiny shape of tests/test_trainer.py (R = 8, nf 32, ch_mult (1, 2),
one block a level, attention at 4^3, num_scales 10, beta_max 2.0, fp32
compute): the flax init, every leaf perturbed with seeded noise (so the
zero-initialised convs carry gradient), goes into the port through
``utils.convert.from_jax_params``; Adam moments start at zero and the EMA
at the weights on both sides. The timestep labels and the noise of each
micro-batch are JAX's own draws (its key splits replayed and handed to the
port as arrays). Tolerances: rtol 2e-4 / atol 2e-5 on values (as
tests/test_torch_parity.py), rtol 1e-3 / atol 1e-6 on gradients, Adam
moments and updated parameters; counts exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from meshdiffusion_tpu.config import get_config as jax_get_config
from meshdiffusion_tpu.diffusion import losses as JL
from meshdiffusion_tpu.diffusion.vpsde import VPSDE as JaxVPSDE
from meshdiffusion_tpu.models import create_model as jax_create_model
from meshdiffusion_tpu.ops.gn_silu_conv import gn_silu_conv3d as jax_gn_silu_conv3d
from meshdiffusion_tpu_torch import ops
from meshdiffusion_tpu_torch.config import get_config
from meshdiffusion_tpu_torch.diffusion import losses as PL
from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
from meshdiffusion_tpu_torch.models import create_model, layers
from meshdiffusion_tpu_torch.utils.convert import from_jax_params

pytest_plugins = ('torch_rules',)

R, MICRO = 8, 2
VAL = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-6)


def configs(dropout=0.0, **optim):
    """The tiny architecture for both packages, fp32 compute."""
    out = []
    for cfg in (jax_get_config('res64'), get_config('res64')):
        cfg.data.image_size = R
        cfg.model.nf = 32
        cfg.model.ch_mult = (1, 2)
        cfg.model.num_res_blocks = 1
        cfg.model.attn_resolutions = (4,)
        cfg.model.num_scales = 10
        cfg.model.beta_max = 2.0
        cfg.model.dropout = dropout
        for k, v in optim.items():
            setattr(cfg.optim, k, v)
        out.append(cfg)
    out[0].tpu.compute_dtype = 'float32'
    out[1].gpu.compute_dtype = 'float32'
    return out


@functools.lru_cache(maxsize=None)
def jax_params(seed=0, noise=0.05):
    """The tiny flax model's init, every leaf perturbed by seeded noise."""
    jcfg, _ = configs()
    model = jax_create_model(jcfg)
    params = jax.jit(model.init)({'params': jax.random.key(seed)}, jnp.zeros((1, R, R, R, 4)),
                                 jnp.zeros((1,)), jnp.ones((1, R, R, R, 1)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: np.asarray(p, np.float32)
                        + noise * rng.standard_normal(p.shape).astype(np.float32), params)


def port_model(pcfg, params=None, **kw):
    from meshdiffusion_tpu_torch.models import get_model
    with torch.device('cpu'):
        model = get_model(pcfg.model.name).from_config(pcfg, **kw)
    model.load_state_dict(from_jax_params(params or jax_params(), pcfg), strict=True)
    return model


def inputs(seed=1, batch=MICRO, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (batch, R, R, R, 4)).astype(np.float32)
    x[..., 0] = np.sign(x[..., 0])
    mask = (rng.random((1, R, R, R, 1)) > 0.3).astype(np.float32)
    return x, mask


def tables(N=10):
    sde = VPSDE(beta_min=0.1, beta_max=2.0, N=N)
    return (torch.from_numpy(sde.sqrt_alphas_cumprod), torch.from_numpy(sde.sqrt_1m_alphas_cumprod))


def assert_grads(model, jax_grads, pcfg, **tol):
    """Every port gradient (None as zeros) against JAX's, in torch layout."""
    want = from_jax_params(jax_grads, pcfg)
    worst = 0.0
    for k, p in model.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), want[k].numpy(), err_msg=k, **tol)
        worst = max(worst, float(want[k].abs().max()))
    assert worst > 1e-3        # the comparison carries signal


@pytest.mark.parametrize('loss_type', ['l2', 'l1'])
@pytest.mark.parametrize('masked', [True, False])
def test_ddpm_loss_and_grads_match_jax(loss_type, masked):
    jcfg, pcfg = configs()
    jmodel, params = jax_create_model(jcfg), jax_params()
    x, mask = inputs()
    rng = np.random.default_rng(2)
    labels = np.array([1, 7], np.int32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    jsde = JaxVPSDE(beta_min=0.1, beta_max=2.0, N=10)
    m = jnp.asarray(mask) if masked else None

    def apply_fn(p, xx, t, mm, train, rngs):
        return jmodel.apply(p, xx, t, mm, train=train, rngs=rngs)

    loss_fn = jax.jit(jax.value_and_grad(lambda p: JL.ddpm_loss(
        apply_fn, p, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(noise),
        jnp.asarray(jsde.sqrt_alphas_cumprod), jnp.asarray(jsde.sqrt_1m_alphas_cumprod),
        m, loss_type, train=True, dropout_rng=jax.random.key(0))))
    want_loss, want_grads = loss_fn(params)

    model = port_model(pcfg)
    loss = PL.ddpm_loss(model, torch.from_numpy(x), torch.from_numpy(labels).long(),
                        torch.from_numpy(noise), *tables(),
                        torch.from_numpy(mask) if masked else None, loss_type, train=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **VAL)
    assert_grads(model, jax.tree.map(np.asarray, want_grads), pcfg, **GRAD)


def _gsc_inputs(seed, C=64, O=32, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 4, 4, C)).astype(dtype) * 1.5 + 0.3
    sc = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bi = (0.1 * rng.standard_normal(C)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, C, O)) * 0.05).astype(np.float32)
    cb = (0.1 * rng.standard_normal(O)).astype(np.float32)
    g = rng.standard_normal((2, 4, 4, 4, O)).astype(np.float32)
    return (x, sc, bi, k, cb), g


def test_gn_silu_conv_function_matches_jax_vjp():
    """The port's differentiable conv op: its value and the VJP of every
    input against ``jax.vjp`` of the JAX package's ``custom_vjp`` op."""
    args, g = _gsc_inputs(0)
    y, vjp = jax.vjp(lambda *a: jax_gn_silu_conv3d(*a, 32, 1e-6, jnp.float32),
                     *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = ops.gn_silu_conv3d(*targs, 32, 1e-6, torch.float32)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **VAL)
    for name, t, w in zip(('x', 'scale', 'bias', 'kernel', 'conv_bias'), targs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=name, **GRAD)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_gn_silu_conv_function_matches_plain_autograd(dtype):
    """Its gradients (``ops.gn_silu_conv3d`` under autograd: the kernel
    forward's route with the plain version's backward) equal autograd's
    through the plain composition, and a permuted (non-contiguous) weight
    view gets its gradient too."""
    args, g = _gsc_inputs(1, C=32, O=64)
    w = torch.from_numpy(np.ascontiguousarray(args[3].transpose(4, 3, 0, 1, 2)))
    outs = []
    for op in (ops.gn_silu_conv3d, ops.gn_silu_conv3d_reference):
        x, sc, bi, cb = (torch.from_numpy(a).requires_grad_(True)
                         for a in (args[0], args[1], args[2], args[4]))
        wt = w.clone().requires_grad_(True)
        out = op(x, sc, bi, wt.permute(2, 3, 4, 1, 0), cb, 32, 1e-6, dtype)
        out.float().backward(torch.from_numpy(g))
        outs.append((out.detach(), [t.grad for t in (x, sc, bi, wt, cb)]))
    (y1, g1), (y2, g2) = outs
    assert y1.dtype == dtype
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _loss_and_grads(model, seed, x, mask, labels, noise):
    torch.manual_seed(seed)
    model.zero_grad(set_to_none=True)
    loss = PL.ddpm_loss(model, x, labels, noise, *tables(), mask)
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()
                         if p.grad is not None}


def test_remat_matches_plain_backward_under_dropout():
    """Remat on against off at dropout 0.1 from one torch seed: the same
    loss and gradients, so the recompute draws the forward's masks; another
    seed gives another loss, so dropout acted."""
    _, pcfg = configs(dropout=0.1)
    x, mask = (torch.from_numpy(a) for a in inputs())
    labels, noise = torch.tensor([2, 8]), torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    on = _loss_and_grads(port_model(pcfg, remat_blocks=True), 7, x, mask, labels, noise)
    off = _loss_and_grads(port_model(pcfg, remat_blocks=False), 7, x, mask, labels, noise)
    other = _loss_and_grads(port_model(pcfg, remat_blocks=True), 8, x, mask, labels, noise)
    assert on[0] == off[0] and on[0] != other[0]
    assert on[1].keys() == off[1].keys() and len(on[1]) > 50
    for k in on[1]:
        torch.testing.assert_close(on[1][k], off[1][k], rtol=0, atol=0, msg=k)


def test_dropout_train_only_and_mean_preserving(monkeypatch):
    """``train=False`` is the model without dropout; ``train=True`` drops
    about 0.1 of the GroupNorm_1 -> SiLU output and scales the rest by
    1/0.9, in every ResnetBlock."""
    _, pcfg = configs(dropout=0.1)
    _, pcfg0 = configs(dropout=0.0)
    x, mask = (torch.from_numpy(a) for a in inputs())
    t = torch.tensor([2.0, 8.0])
    model, model0 = port_model(pcfg), port_model(pcfg0)
    with torch.no_grad():
        torch.testing.assert_close(model(x, t, mask), model0(x, t, mask, train=True),
                                   rtol=0, atol=0)
        seen, dropout = [], layers.F.dropout

        def recording(h, p, training):
            out = dropout(h, p, training)
            seen.append((h, out, p))
            return out
        monkeypatch.setattr(layers.F, 'dropout', recording)
        y = model(x, t, mask, train=True)
    blocks = sum(isinstance(m, layers.ResnetBlockDDPM) for m in model.modules())
    assert len(seen) == blocks and not torch.allclose(y, model0(x, t, mask))
    kept = torch.cat([(o != 0).flatten() for _, o, _ in seen]).float()
    assert all(p == 0.1 for _, _, p in seen)
    assert abs(1.0 - float(kept.mean()) - 0.1) < 0.01, float(kept.mean())
    for h, o, _ in seen:
        nz = o != 0
        torch.testing.assert_close(o[nz], h[nz] / 0.9)


def _adam_state(opt_state):
    return [s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: isinstance(
        s, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)][0]


def jax_draws(rng_key, batch_shape, N=10):
    """JAX make_train_step's labels and noise for each micro-batch of one
    step, as numpy: split(state.rng), then a split a micro-batch, then
    split(sub, 3) -> (t, noise, dropout)."""
    rng, _ = jax.random.split(rng_key)
    out = []
    for _ in range(batch_shape[0]):
        rng, sub = jax.random.split(rng)
        rng_t, rng_n, _ = jax.random.split(sub, 3)
        out.append((np.asarray(jax.random.randint(rng_t, (batch_shape[1],), 0, N)),
                    np.asarray(jax.random.normal(rng_n, batch_shape[1:], jnp.float32))))
    return out


@pytest.mark.parametrize('warmup,clip,steps', [(2, 0.05, 2), (0, 1e3, 1)],
                         ids=['warmup2-clip-active', 'warmup0-clip-idle'])
def test_train_step_matches_jax(warmup, clip, steps):
    """iter_size 2, at the res64 preset's rate: the mean loss, the summed
    gradients through the clip and Adam (the first update 0 under
    warm-up), the moments, the EMA and its count, against JAX's
    make_train_step, step after step.

    Adam divides each gradient by its own RMS, so an update is pinned only
    where the gradient is pinned. The moments are compared bias-corrected,
    as the gradients' mean and RMS, at the gradients' tolerance; each
    parameter's update, and its EMA, at that tolerance wherever JAX's RMS
    gradient is above the gradients' atol. Below it (rounding-level
    gradients, such as a conv bias that a one-channel-a-group GroupNorm
    cancels) the two updates are the signs of rounding noise, and only
    Adam's bound on a step is held, on the port's side."""
    jcfg, pcfg = configs(warmup=warmup, grad_clip=clip)
    assert pcfg.optim.lr == jcfg.optim.lr == 2e-5
    jmodel = jax_create_model(jcfg)
    jsde = JaxVPSDE(beta_min=0.1, beta_max=2.0, N=10)
    x, mask = inputs(lead=(2,))
    tx = JL.get_optimizer(jcfg)
    jstate = JL.TrainState.create(jax.tree.map(jnp.asarray, jax_params()), tx, jax.random.key(5))
    jstep = jax.jit(JL.make_train_step(jmodel, jsde, tx, jnp.asarray(mask), ema_decay=0.9999,
                                       iter_size=2))

    model = port_model(pcfg)
    state = PL.TrainState.create(model, pcfg, torch.Generator())
    step = PL.make_train_step(VPSDE(beta_min=0.1, beta_max=2.0, N=10), torch.from_numpy(mask))
    params = dict(model.named_parameters())
    jtorch = lambda tree: from_jax_params(jax.tree.map(np.asarray, tree), pcfg)
    for n in range(steps):
        before = {k: p.detach().clone() for k, p in params.items()}
        jbefore = jtorch(jstate.params)
        draws = jax_draws(jstate.rng, x.shape)
        jstate, jm = jstep(jstate, jnp.asarray(x))
        src = lambda j, shape: (torch.tensor(draws[j][0]).long(), torch.tensor(draws[j][1]))
        out = step(state, torch.from_numpy(x), src)
        assert (float(out['grad_norm']) > clip) == (warmup > 0)    # the clip acts in one case only
        np.testing.assert_allclose(float(out['loss']), float(jm['loss']), **VAL)
        assert state.step == int(jstate.step) == n + 1
        assert state.ema.num_updates == int(jstate.ema_num_updates) == n + 1
        want, ema = jtorch(jstate.params), jtorch(jstate.ema_params)
        adam = _adam_state(jstate.opt_state)
        mu, nu = jtorch(adam.mu), jtorch(adam.nu)
        t, lr = n + 1, state.optimizer.lr_at(n)
        pinned = total = 0
        for k, p in params.items():
            st = state.optimizer.adam.state[p]
            rms = (nu[k] / (1 - 0.999 ** t)).sqrt()
            np.testing.assert_allclose(st['exp_avg'] / (1 - 0.9 ** t), mu[k] / (1 - 0.9 ** t),
                                       err_msg=k, **GRAD)
            np.testing.assert_allclose((st['exp_avg_sq'] / (1 - 0.999 ** t)).sqrt(), rms,
                                       err_msg=k, **GRAD)
            dp, dp_want = p.detach() - before[k], want[k] - jbefore[k]
            sure = rms >= GRAD['atol']
            np.testing.assert_allclose(dp[sure], dp_want[sure], err_msg=k, **GRAD)
            np.testing.assert_allclose(state.ema.shadow[k][sure], ema[k][sure], err_msg=k, **GRAD)
            assert bool((dp[~sure].abs() <= 1.01 * lr).all()), k
            pinned, total = pinned + int(sure.sum()), total + p.numel()
        assert pinned > 0.9 * total, (pinned, total)
        moved = max(float((p.detach() - before[k]).abs().max()) for k, p in params.items())
        if n == 0 and warmup > 0:
            assert moved == 0.0           # lr 0 at the first update
        else:
            assert moved > 0.5 * lr


def test_eval_step_matches_jax():
    """The eval loss on the EMA weights, train=False, against JAX's
    make_eval_step; the model's own weights are left as they were."""
    jcfg, pcfg = configs(dropout=0.1)
    jmodel = jax_create_model(jcfg)
    jsde = JaxVPSDE(beta_min=0.1, beta_max=2.0, N=10)
    x, mask = inputs()
    params, ema = jax_params(0), jax_params(1)
    jstate = JL.TrainState.create(jax.tree.map(jnp.asarray, params), JL.get_optimizer(jcfg),
                                  jax.random.key(0))
    jstate = jstate.replace(ema_params=jax.tree.map(jnp.asarray, ema))
    key = jax.random.key(9)
    want = jax.jit(JL.make_eval_step(jmodel, jsde, jnp.asarray(mask)))(jstate, jnp.asarray(x), key)
    rng_t, rng_n = jax.random.split(key)
    labels = np.asarray(jax.random.randint(rng_t, (MICRO,), 0, 10))
    noise = np.asarray(jax.random.normal(rng_n, x.shape, jnp.float32))

    model = port_model(pcfg)
    state = PL.TrainState.create(model, pcfg, torch.Generator())
    state.ema.shadow = from_jax_params(ema, pcfg)
    weights = {k: p.detach().clone() for k, p in model.named_parameters()}
    got = PL.make_eval_step(VPSDE(beta_min=0.1, beta_max=2.0, N=10), torch.from_numpy(mask))(
        state, torch.from_numpy(x),
        lambda j, shape: (torch.tensor(labels).long(), torch.tensor(noise)))
    np.testing.assert_allclose(float(got['loss']), float(want['loss']), **VAL)
    for k, p in model.named_parameters():
        assert torch.equal(p, weights[k]), k


def test_optimizer_step_rebuilds_weight_caches():
    """An Adam step (foreach, as on the card) bumps every weight's version,
    so the convs' cached kernel layouts are rebuilt on the next forward; the
    live weight view carries the gradient, the cached copy none."""
    _, pcfg = configs()
    model = port_model(pcfg)
    conv = next(m for m in model.modules() if isinstance(m, layers.ResnetBlockDDPM)).Conv_0
    cached = conv.dhwio()
    assert not cached.requires_grad
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, foreach=True)
    x, mask = (torch.from_numpy(a) for a in inputs())
    PL.ddpm_loss(model, x, torch.tensor([1, 2]), torch.randn(x.shape), *tables(), mask).backward()
    assert conv.weight.grad is not None and float(conv.weight.grad.abs().max()) > 0
    v = conv.weight._version
    opt.step()
    assert conv.weight._version > v
    with torch.no_grad():
        fresh = conv.dhwio()
    assert fresh is not cached
    torch.testing.assert_close(fresh, conv.weight.detach().permute(2, 3, 4, 1, 0))
