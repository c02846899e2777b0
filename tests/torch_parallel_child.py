"""One rank of tests/test_torch_parallel.py's spawned job (gloo on the CPU).

    python tests/torch_parallel_child.py WORKDIR RANK WORLD PORT

Joins a 4-rank process group, builds the (2, 2) and (1, 4) meshes, runs the
port's sharded pieces on this rank's shards of the inputs the parent wrote
to ``WORKDIR/inputs.npz`` (and the U-Net weights in ``WORKDIR/weights.pt``),
and writes what it computed to ``WORKDIR/rank{RANK}.pt``; the parent holds
it against the JAX package. Imports no JAX.
"""

import os
import sys

import numpy as np
import torch

R = 8
HALO_CASES = {'halo11': (1, 1, False), 'pad22': (2, 2, True), 'pad01': (0, 1, True)}


def tiny_config(**optim):
    """tests/test_torch_train.py's tiny architecture, fp32 compute."""
    from meshdiffusion_tpu_torch.config import get_config
    cfg = get_config('res64')
    cfg.data.image_size = R
    cfg.model.nf = 32
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.attn_resolutions = (4,)
    cfg.model.num_scales = 10
    cfg.model.beta_max = 2.0
    cfg.model.dropout = 0.0
    cfg.gpu.compute_dtype = 'float32'
    for k, v in optim.items():
        setattr(cfg.optim, k, v)
    return cfg


def model(cfg, weights):
    from meshdiffusion_tpu_torch.models import get_model
    m = get_model(cfg.model.name).from_config(cfg)
    m.load_state_dict(weights, strict=True)
    return m


def slab(a, mesh, batch_dim=0):
    from meshdiffusion_tpu_torch.parallel import shard_batch
    return torch.from_numpy(np.ascontiguousarray(shard_batch(a, mesh, True, batch_dim)))


def main(work: str, rank: int, world: int, port: int) -> None:
    import torch.distributed as dist
    from meshdiffusion_tpu_torch import ops
    from meshdiffusion_tpu_torch.diffusion import losses as PL
    from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
    from meshdiffusion_tpu_torch.parallel import distributed, make_mesh, spatial
    assert distributed.maybe_initialize('gloo', f'localhost:{port}', world, rank)
    meshes = {'2x2': make_mesh(2, 2), '1x4': make_mesh(1, 4)}
    inp = dict(np.load(os.path.join(work, 'inputs.npz')))
    weights = torch.load(os.path.join(work, 'weights.pt'))
    out = {'coords': {k: (m.data_index, m.spatial_index) for k, m in meshes.items()}}

    # the halo exchange, forward and backward, on the (1, 4) mesh
    m = meshes['1x4']
    for case, (lo, hi, pad) in HALO_CASES.items():
        x = slab(inp['halo_x'], m).requires_grad_(True)
        with spatial.sharded(m):
            y = spatial.pad_depth(x, lo, hi) if pad else spatial.halo(x, lo, hi)
        g = np.random.default_rng(100 + rank).standard_normal(y.shape).astype(np.float32)
        y.backward(torch.from_numpy(g))
        out[case] = {'y': y.detach().numpy(), 'gx': x.grad.numpy()}

    # the GroupNorm -> SiLU -> conv chain: the moments merged over the slabs,
    # the conv's depth-halo mode, under autograd
    names = ('chain_scale', 'chain_bias', 'chain_kernel', 'chain_conv_bias')
    for key, m in meshes.items():
        x = slab(inp['chain_x'], m).requires_grad_(True)
        params = [torch.from_numpy(inp[n]).requires_grad_(True) for n in names]
        with spatial.sharded(m) as sh:
            a, b = spatial.gn_affine(x, params[0], params[1], 32, 1e-6)
            y = ops.gn_silu_conv3d_halo(spatial.halo(x, 1, 1), a, b, params[2], params[3],
                                        sh.halo_sizes(1), torch.float32)
            y.backward(slab(inp['chain_g'], m))
        out['chain_' + key] = {'y': y.detach().numpy(), 'gx': x.grad.numpy(),
                               **{n: p.grad.numpy() for n, p in zip(names, params)}}

    # the U-Net forward on each mesh
    cfg = tiny_config()
    net = model(cfg, weights).eval()
    for key, m in meshes.items():
        nb = inp['unet_x'].shape[0] // m.data
        labels = torch.from_numpy(inp['unet_t'][m.data_index * nb:(m.data_index + 1) * nb])
        d0, d1 = m.depth_range(R)
        with torch.no_grad(), spatial.sharded(m):
            y = net(slab(inp['unet_x'], m), labels, torch.from_numpy(inp['mask'][:, d0:d1]))
        out['unet_' + key] = y.numpy()

    # the train step on the (2, 2) mesh: iter_size 2, one sample a data row
    m = meshes['2x2']
    cfg = tiny_config(warmup=0, grad_clip=0.05)
    net = model(cfg, weights)
    state = PL.TrainState.create(net, cfg, torch.Generator())
    step = PL.make_train_step(VPSDE(beta_min=0.1, beta_max=2.0, N=10),
                              torch.from_numpy(inp['train_mask']), mesh=m)
    grads, optimizer_step = {}, state.optimizer.step

    def capture(n):
        grads.update({k: p.grad.clone() for k, p in net.named_parameters()})
        return optimizer_step(n)
    state.optimizer.step = capture
    d = m.data_index
    src = lambda j, shape: (torch.from_numpy(inp['train_t'][j, d:d + 1]).long(),
                            torch.from_numpy(inp['train_noise'][j, d:d + 1]))
    res = step(state, slab(inp['train_x'], m, batch_dim=1), src)
    adam = [state.optimizer.adam.state[p] for p in net.parameters()]
    out['train'] = {
        'loss': float(res['loss']), 'grad_norm': float(res['grad_norm']),
        'grads': {k: g.numpy() for k, g in grads.items()},
        'params': {k: p.detach().numpy() for k, p in net.named_parameters()},
        'exp_avg': {k: s['exp_avg'].numpy() for k, s in zip(dict(net.named_parameters()), adam)},
        'exp_avg_sq': {k: s['exp_avg_sq'].numpy()
                       for k, s in zip(dict(net.named_parameters()), adam)},
        'ema': {k: v.numpy() for k, v in state.ema.shadow.items()}}
    torch.save(out, os.path.join(work, f'rank{rank}.pt'))
    dist.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
