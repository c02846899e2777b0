"""The port's data- and spatial-parallel training against the JAX package.

On the CPU in float32, at tests/test_torch_train.py's tiny shape (R = 8,
nf 32, ch_mult (1, 2), one block a level, attention at 4^3, dropout 0):

* in this process: the mesh layout and ``shard_batch`` (against the
  addressable shards of JAX's ``shard_batch`` on the 8 virtual CPU
  devices), the moments merge and fold (against JAX's ``_gn_affine`` on the
  whole tensor), the halo conv's plain version on hand-cut slabs (against
  JAX's ``gn_silu_conv3d_reference``);
* one spawned job of 4 gloo ranks (``tests/torch_parallel_child.py``, each
  on the worker's thread share) holding the (2, 2) and (1, 4) meshes: the halo
  exchange forward and backward against an unsharded autograd, the sharded
  GN -> SiLU -> conv chain against JAX's ``custom_vjp``, the sharded U-Net
  forward (one plane a slab on level 1 at (1, 4)) against JAX's apply and
  against the same apply jitted with x sharded over JAX's own (2, 2) mesh,
  and the (2, 2) train step against JAX's ``make_train_step``.

Tolerances as tests/test_torch_train.py: rtol 2e-4 / atol 2e-5 on values,
rtol 1e-3 / atol 1e-6 on gradients, Adam moments and updated parameters;
layouts and halo copies exact.
"""

import functools
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from meshdiffusion_tpu.diffusion import losses as JL
from meshdiffusion_tpu.diffusion.vpsde import VPSDE as JaxVPSDE
from meshdiffusion_tpu.models import create_model as jax_create_model
from meshdiffusion_tpu.ops.gn_silu_conv import _gn_affine
from meshdiffusion_tpu.ops.gn_silu_conv import gn_silu_conv3d as jax_gn_silu_conv3d
from meshdiffusion_tpu.ops.gn_silu_conv import gn_silu_conv3d_reference as jax_chain_reference
from meshdiffusion_tpu.parallel import make_mesh as jax_make_mesh
from meshdiffusion_tpu.parallel import shard_batch as jax_shard_batch
from meshdiffusion_tpu_torch import ops
from meshdiffusion_tpu_torch.parallel import make_mesh, shard_batch
from meshdiffusion_tpu_torch.parallel.distributed import process_local_batch_size
from meshdiffusion_tpu_torch.utils.convert import from_jax_params
from test_torch_train import GRAD, VAL, _adam_state, configs, jax_draws, jax_params

pytest_plugins = ('torch_rules',)

REPO = pathlib.Path(__file__).resolve().parents[1]
CHILD = REPO / 'tests' / 'torch_parallel_child.py'
WORLD, R = 4, 8
HALO_CASES = {'halo11': (1, 1, False), 'pad22': (2, 2, True), 'pad01': (0, 1, True)}
CHAIN = ('chain_scale', 'chain_bias', 'chain_kernel', 'chain_conv_bias')


def test_make_mesh_shapes():
    """JAX's layout, rank = data_index * spatial + spatial_index, and its
    assertion on a mesh that does not match the world."""
    m = make_mesh(-1, 2, world_size=8, rank=5)
    assert (m.data, m.spatial, m.data_index, m.spatial_index) == (4, 2, 2, 1)
    assert m.depth_range(64) == (32, 64)
    m = make_mesh(8, 1, world_size=8, rank=3)
    assert (m.data, m.spatial, m.data_index, m.spatial_index) == (8, 1, 3, 0)
    assert make_mesh(2, 2, world_size=4, rank=3).spatial_group is None    # no process group here
    with pytest.raises(AssertionError):
        make_mesh(3, 2, world_size=8, rank=0)
    with pytest.raises(AssertionError):
        make_mesh(-1, 3, world_size=8, rank=0)
    single = make_mesh()
    assert (single.data, single.spatial, single.rank) == (1, 1, 0)


def test_process_local_batch_size():
    assert process_local_batch_size(48, 4) == 12
    assert process_local_batch_size(8, 1) == 8
    with pytest.raises(ValueError):
        process_local_batch_size(50, 4)


def test_shard_batch_matches_jax_addressable_shards():
    """Rank r's slice is what device r holds of JAX's shard_batch(x,
    make_mesh(-1, 2), spatial=True): B over data, D over spatial."""
    x = np.arange(8 * 4 * 4 * 4 * 2, dtype=np.float32).reshape(8, 4, 4, 4, 2)
    y = jax_shard_batch(x, jax_make_mesh(-1, 2), spatial=True)
    shards = {s.device: np.asarray(s.data) for s in y.addressable_shards}
    for r, dev in enumerate(jax.devices()):
        got = shard_batch(x, make_mesh(-1, 2, world_size=8, rank=r), spatial=True)
        np.testing.assert_array_equal(got, shards[dev])
        # with a leading iter_size axis, as the trainer and the train step have it
        lead = shard_batch(np.stack([x, x + 1]), make_mesh(-1, 2, world_size=8, rank=r),
                           spatial=True, batch_dim=1)
        np.testing.assert_array_equal(lead[1], shards[dev] + 1)


def _chain_inputs(seed=0, C=64, O=32, D=R):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, D, 4, 4, C)).astype(np.float32) * 1.5 + 0.3
    return {'chain_x': x,
            'chain_scale': (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32),
            'chain_bias': (0.1 * rng.standard_normal(C)).astype(np.float32),
            'chain_kernel': (rng.standard_normal((3, 3, 3, C, O)) * 0.05).astype(np.float32),
            'chain_conv_bias': (0.1 * rng.standard_normal(O)).astype(np.float32),
            'chain_g': rng.standard_normal((2, D, 4, 4, O)).astype(np.float32)}


def _slabs(x, S):
    return [torch.from_numpy(np.ascontiguousarray(s)) for s in np.split(x, S, axis=1)]


@pytest.mark.parametrize('S', [2, 4])
def test_moments_merge_matches_jax_gn_affine(S):
    """Each slab's moments (the plain version), merged in slab order and
    folded, give JAX's _gn_affine of the whole tensor."""
    c = _chain_inputs()
    x, sc, bi = c['chain_x'], c['chain_scale'], c['chain_bias']
    want = _gn_affine(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi), 32, 1e-6)
    moments = torch.stack([ops.gn_moments(s, 32) for s in _slabs(x, S)])
    assert moments.shape == (S, 2, 32, 2)
    mean, m2, n = ops.merge_moments(moments, x[0].size // S // 32)
    assert n == x[0].size // 32
    a, b = ops.affine_from_moments(mean, m2, n, torch.from_numpy(sc), torch.from_numpy(bi), 1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(want[0]), **VAL)
    np.testing.assert_allclose(b.numpy(), np.asarray(want[1]), **VAL)


def test_gn_moments_backward_is_exact():
    """gn_moments' hand-written backward (its route under autograd) against
    autograd through its plain version."""
    x = torch.from_numpy(_chain_inputs()['chain_x'][:, :4])
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 32, 2)).astype(np.float32))
    grads = []
    for fn in (ops.gn_moments, ops.gn_moments_reference):
        xx = x.clone().requires_grad_(True)
        fn(xx, 32).backward(g)
        grads.append(xx.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('S', [2, 4])
def test_halo_conv_plain_on_slabs_matches_jax(S):
    """The depth-halo mode's plain version on hand-cut slabs, each with its
    neighbours' boundary planes and the whole tensor's a, b, concatenated:
    JAX's gn_silu_conv3d_reference of the whole tensor."""
    c = _chain_inputs()
    args = [jnp.asarray(c[k]) for k in ('chain_x',) + CHAIN]
    want = jax_chain_reference(*args, 32, 1e-6, jnp.float32)
    x = torch.from_numpy(c['chain_x'])
    a, b = ops.gn_affine_reference(x, torch.from_numpy(c['chain_scale']),
                                   torch.from_numpy(c['chain_bias']))
    d = R // S
    outs = []
    for s in range(S):
        lo, hi = int(s > 0), int(s < S - 1)
        outs.append(ops.gn_silu_conv3d_halo(x[:, s * d - lo:(s + 1) * d + hi], a, b,
                                            torch.from_numpy(c['chain_kernel']),
                                            torch.from_numpy(c['chain_conv_bias']), (lo, hi),
                                            torch.float32))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), np.asarray(want), **VAL)


# ---- the spawned job: 4 gloo ranks, the (2, 2) and (1, 4) meshes ----

@functools.lru_cache(maxsize=None)
def _train_reference():
    """The inputs of the (2, 2) train step and JAX's step on them:
    (x (2, 2, R, R, R, 4), mask, labels (2, 2), noise, new state, metrics)."""
    jcfg, _ = configs(warmup=0, grad_clip=0.05)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 2, R, R, R, 4)).astype(np.float32)
    x[..., 0] = np.sign(x[..., 0])
    mask = (rng.random((1, R, R, R, 1)) > 0.3).astype(np.float32)
    tx = JL.get_optimizer(jcfg)
    jstate = JL.TrainState.create(jax.tree.map(jnp.asarray, jax_params()), tx, jax.random.key(5))
    draws = jax_draws(jstate.rng, x.shape)
    jstep = jax.jit(JL.make_train_step(jax_create_model(jcfg), JaxVPSDE(beta_min=0.1,
                                                                      beta_max=2.0, N=10),
                                       tx, jnp.asarray(mask), ema_decay=0.9999, iter_size=2))
    jstate, jm = jstep(jstate, jnp.asarray(x))
    labels = np.stack([d[0] for d in draws]).astype(np.int64)
    noise = np.stack([d[1] for d in draws])
    return x, mask, labels, noise, jstate, jm


@functools.lru_cache(maxsize=None)
def _unet_reference():
    """The U-Net inputs and JAX's apply on them, unsharded and jitted with x
    sharded over JAX's (2, 2) mesh of 4 of the virtual devices."""
    jcfg, _ = configs()
    jmodel = jax_create_model(jcfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, R, R, R, 4)).astype(np.float32)
    t = np.array([1.0, 7.0], np.float32)
    mask = (rng.random((1, R, R, R, 1)) > 0.3).astype(np.float32)
    fn = jax.jit(lambda p, x, t, m: jmodel.apply(p, x, t, m, train=False))
    params = jax_params()
    want = np.asarray(fn(params, x, t, mask))
    mesh = jax_make_mesh(2, 2, devices=jax.devices()[:4])
    xs = jax_shard_batch(x, mesh, spatial=True)
    ts = jax.device_put(t, NamedSharding(mesh, P('data')))
    want_mesh = fn(params, xs, ts, mask)
    assert len(want_mesh.addressable_shards) == 4
    return x, t, mask, want, np.asarray(want_mesh)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def job(tmp_path_factory):
    """Runs the 4 ranks on the inputs of every spawned check; their outputs
    by rank."""
    work = tmp_path_factory.mktemp('parallel')
    _, pcfg = configs()
    torch.save(from_jax_params(jax_params(), pcfg), work / 'weights.pt')
    ux, ut, umask, _, _ = _unet_reference()
    tx, tmask, tl, tn, _, _ = _train_reference()
    rng = np.random.default_rng(4)
    np.savez(work / 'inputs.npz',
             halo_x=rng.standard_normal((2, R, 3, 3, 5)).astype(np.float32),
             unet_x=ux, unet_t=ut, mask=umask, train_x=tx, train_mask=tmask, train_t=tl,
             train_noise=tn, **_chain_inputs())
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, str(CHILD), str(work), str(r), str(WORLD),
                               str(port)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r}:\n{err[-3000:]}'
    return [torch.load(work / f'rank{r}.pt', weights_only=False) for r in range(WORLD)], \
        dict(np.load(work / 'inputs.npz'))


def test_spawned_mesh_coordinates(job):
    res, _ = job
    for r, out in enumerate(res):
        assert out['coords'] == {'2x2': divmod(r, 2), '1x4': (0, r)}


@pytest.mark.parametrize('case', list(HALO_CASES))
def test_halo_exchange_matches_unsharded(job, case):
    """Each rank's slab with its neighbours' planes (and zeros at the ends
    where padded) is that window of the whole tensor; the gradients each
    rank sends back sum, on the owner, to the unsharded autograd's."""
    res, inp = job
    lo, hi, pad = HALO_CASES[case]
    x = torch.from_numpy(inp['halo_x']).requires_grad_(True)
    padded = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 0, lo, hi))
    d = R // WORLD
    total = 0.0
    for r, out in enumerate(res):
        start = r * d if pad else max(r * d - lo, 0)
        stop = (r + 1) * d + lo + hi if pad else min((r + 1) * d + hi, R)
        window = (padded if pad else x)[:, start:stop]
        np.testing.assert_array_equal(out[case]['y'], window.detach().numpy())
        g = np.random.default_rng(100 + r).standard_normal(window.shape).astype(np.float32)
        total = total + (window * torch.from_numpy(g)).sum()
    total.backward()
    got = np.concatenate([out[case]['gx'] for out in res], axis=1)
    np.testing.assert_allclose(got, x.grad.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('mesh', ['2x2', '1x4'])
def test_sharded_chain_matches_jax_vjp(job, mesh):
    """The sharded GN -> SiLU -> conv (the whole tensor's moments, the halo
    mode under autograd): the slabs' outputs and x gradients put together,
    and the parameter gradients summed over the ranks, against jax.vjp of
    the JAX package's custom_vjp op on the whole tensor."""
    res, inp = job
    args = [jnp.asarray(inp[k]) for k in ('chain_x',) + CHAIN]
    y, vjp = jax.vjp(lambda *a: jax_gn_silu_conv3d(*a, 32, 1e-6, jnp.float32), *args)
    want = vjp(jnp.asarray(inp['chain_g']))
    outs = [out['chain_' + mesh] for out in res]
    S = 2 if mesh == '2x2' else 4
    rows = [np.concatenate([outs[d * S + s][k] for s in range(S)], axis=1)
            for k in ('y', 'gx') for d in range(WORLD // S)]
    n = WORLD // S
    np.testing.assert_allclose(np.concatenate(rows[:n]), np.asarray(y), **VAL)
    np.testing.assert_allclose(np.concatenate(rows[n:]), np.asarray(want[0]), **GRAD)
    for name, w in zip(CHAIN, want[1:]):
        # each rank's partial sum, then the ranks': fp32 sums in another order,
        # so atol scales with the gradient's largest entry (13 for the kernel)
        w = np.asarray(w)
        np.testing.assert_allclose(sum(o[name] for o in outs), w, err_msg=name, rtol=GRAD['rtol'],
                                   atol=GRAD['atol'] * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize('mesh', ['2x2', '1x4'])
def test_sharded_unet_forward_matches_jax(job, mesh):
    """The U-Net on each rank's slab (weights from JAX's through
    from_jax_params), put together, against JAX's apply on the whole batch
    and against the same apply jitted with x sharded over JAX's (2, 2) mesh
    (XLA's spatial partitioning)."""
    res, _ = job
    _, _, _, want, want_mesh = _unet_reference()
    S = 2 if mesh == '2x2' else 4
    got = np.concatenate([np.concatenate([res[d * S + s]['unet_' + mesh] for s in range(S)],
                                         axis=1) for d in range(WORLD // S)])
    np.testing.assert_allclose(got, want, **VAL)
    np.testing.assert_allclose(got, want_mesh, **VAL)


def test_sharded_train_step_matches_jax(job):
    """One (2, 2) step, iter_size 2, the clip active, JAX's labels and noise
    replayed: the loss, the all-reduced gradient (clipped, as Adam's first
    moment sees it), the moments and the updated weights and EMA against
    JAX's make_train_step, on rank 0; every rank's state bit-equal."""
    res, _ = job
    _, pcfg = configs(warmup=0, grad_clip=0.05)
    *_, jstate, jm = _train_reference()
    out = res[0]['train']
    np.testing.assert_allclose(out['loss'], float(jm['loss']), **VAL)
    clip = pcfg.optim.grad_clip
    assert out['grad_norm'] > clip                        # the clip acts
    scale = clip / out['grad_norm']
    jt = lambda tree: {k: v.numpy() for k, v in from_jax_params(
        jax.tree.map(np.asarray, tree), pcfg).items()}
    adam = _adam_state(jstate.opt_state)
    mu, nu, want, ema = jt(adam.mu), jt(adam.nu), jt(jstate.params), jt(jstate.ema_params)
    before = {k: v.numpy() for k, v in from_jax_params(jax_params(), pcfg).items()}
    lr, pinned, total = pcfg.optim.lr, 0, 0
    for k, g in out['grads'].items():
        np.testing.assert_allclose(g * scale, mu[k] / 0.1, err_msg=k, **GRAD)
        np.testing.assert_allclose(out['exp_avg'][k], mu[k], err_msg=k, **GRAD)
        rms = np.sqrt(nu[k] / 0.001)
        np.testing.assert_allclose(np.sqrt(out['exp_avg_sq'][k] / 0.001), rms, err_msg=k, **GRAD)
        # Adam's update is pinned only where the gradient is (test_torch_train)
        sure = rms >= GRAD['atol']
        dp, dp_want = out['params'][k] - before[k], want[k] - before[k]
        np.testing.assert_allclose(dp[sure], dp_want[sure], err_msg=k, **GRAD)
        np.testing.assert_allclose(out['ema'][k][sure], ema[k][sure], err_msg=k, **GRAD)
        assert (np.abs(dp[~sure]) <= 1.01 * lr).all(), k
        pinned, total = pinned + int(sure.sum()), total + g.size
    assert pinned > 0.9 * total, (pinned, total)
    for r in range(1, WORLD):
        for part in ('params', 'exp_avg', 'exp_avg_sq', 'ema', 'grads'):
            for k, v in res[0]['train'][part].items():
                np.testing.assert_array_equal(res[r]['train'][part][k], v, err_msg=(r, part, k))
