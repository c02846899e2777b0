"""DMTet dataset fitting: two-pass optimization of per-mesh SDF + deform.

Counterpart of ``meshdiffusion_tpu/fitting/fit.py`` (reference
``nvdiffrec/fit_dmtets.py``: optimize_mesh:372-534, the two-pass
driver:636-812). Per mesh, pass 1 optimizes sdf + deform (and, unless
``normal_only``, a neural kd/ks/normal material) against GT renders;
pass 2 freezes the topology (sdf = its sign) and refines deform under a
Laplacian relative to the pass-1 vertices. One iteration is GT target +
candidate render + losses + backward + Adam updates + state maintenance
(shrink, carve, clamp, EMA), in that order. The GT is lit by a constant
white light, an HDR environment map (``envmap``) or, with ``learn_light``,
a light the fit optimizes; ``random_lgt`` turns the light at random for
every target batch. After pass 2, ``validate`` renders the fit against
the GT at circular poses and ``save_baked`` writes the mesh with the
material baked into UV textures.

The driver keeps the JAX package's capacity handling: the overflow
counters of a step are read one step late, after the next step has been
queued, so reading them never stalls the card; when a capacity (raster_K,
raster_Kg, raster_live, shade_cap, aa_budget) has to grow, the run rolls
back to the snapshot before the overflowing step and redoes it, so no kept
iteration trained clipped, except at a hard cap, where the clipped
iteration is kept and an error is logged.

Outputs match the reference's on-disk contract:
``tets_pre/dmt_dict_{i:05d}.pt`` {sdf, sdf_ema, deform (masked),
deform_unmasked} and ``tets/dmt_dict_{i:05d}.pt`` {sdf (sign), deform
(masked), deform_unmasked} (fit_dmtets.py:734-739,787-793); with
``validate`` ``val_viz/dmtet_validate_{i}/metrics.txt`` and its PNGs, with
``save_baked`` ``baked/{i:05d}/mesh.obj``, ``mesh.mtl`` and textures.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..geometry.fit_losses import torch_uniform
from ..geometry.tet_grid import TetGrid
from ..render import light as light_mod
from ..render import mesh as mesh_mod
from ..render import obj as obj_mod
from ..render.material import Material
from ..render.mlptexture import MLPTexture3D
from ..render.ops import image_loss
from ..render.rasterize import grow_capacity
from ..render.render import Normal, torch_normal
from ..render.texture import Texture2D
from .dataset import TargetRenderer
from .geometry import DMTetFitter, FitState, FixedTopoFitter

logger = logging.getLogger(__name__)


def lr_schedule(base_lr: float, warmup_iter: int = 0):
    """Reference fit_dmtets.py:396-399, evaluated at an optimizer's own
    update count (as optax evaluates it)."""
    def fn(count: int) -> float:
        if count < warmup_iter:
            return base_lr * count / max(warmup_iter, 1)
        return base_lr * max(10.0 ** (-(count - warmup_iter) * 0.0002), 0.0)
    return fn


def make_image_loss(name: str = 'logl1'):
    """Reference eval.py:50-62 loss table."""
    table = {
        'smape': ('smape', 'none'),
        'mse': ('mse', 'none'),
        'logl1': ('l1', 'log_srgb'),
        'logl2': ('mse', 'log_srgb'),
        'relmse': ('relmse', 'none'),
    }
    loss, tm = table[name]
    return lambda img, ref: image_loss(img, ref, loss=loss, tonemapper=tm)


@dataclasses.dataclass
class FitConfig:
    """Mirror of nvdiffrec/configs/res64.json + argparse defaults."""
    iter: int = 5000
    batch: int = 4
    train_res: Tuple[int, int] = (512, 512)
    learning_rate: Tuple[float, float] = (0.01, 0.003)
    loss: str = 'logl1'
    dmtet_grid: int = 64
    mesh_scale: float = 1.1
    env_scale: float = 1.0
    envmap: Optional[str] = None
    first_stage_deform: float = 2.0
    second_stage_deform: float = 3.0
    sdf_regularizer: float = 0.2
    laplace_scale: float = 10000.0
    learn_light: bool = False
    random_lgt: bool = False
    cam_radius: float = 3.0
    tet_root: Optional[str] = None
    normal_only: bool = True
    raster_K: int = 256
    raster_Kg: int = 64            # global big-triangle list capacity
    antialias: bool = True         # analytic edge AA (dr.antialias equivalent)
    # compacted-AA silhouette-pair budget; None = B*(H+W)*8. Grown on
    # aa_overflow like raster_K.
    aa_budget: Optional[int] = None
    # pre-binning live-face compaction capacity (rasterize_select)
    raster_live: int = 65536
    # covered-pixel compaction of the shading chain: -1 = H*W // 4,
    # 0 = dense, >0 explicit; grown on shade_overflow up to H*W
    shade_cap: int = -1
    save_baked: bool = False
    surface_samples: int = 50000
    # pre-rendered GT view-batch pool (TargetRenderer.target_pool); 0 = a
    # GT render every iteration, as the reference does
    target_pool: int = 64
    log_interval: int = 10
    validate: bool = False
    validate_views: int = 8


def default_material(device=None) -> Material:
    """Reference fit_dmtets.py:638-645."""
    return Material({
        'name': '_default_mat',
        'bsdf': 'diffuse',
        'uniform': True,
        'kd': Texture2D(np.asarray([0.75, 0.3, 0.6], np.float32)),
        'ks': Texture2D(np.asarray([0.0, 0.0, 0.0], np.float32)),
    }).to(device)


def make_mlp_material(aabb, channels: int = 9, device=None) -> MLPTexture3D:
    """The neural kd_ks_normal material (reference eval.py:134-142): kd in
    [0, 1]^3, ks in [0, 0.08, 0] .. 1, the normal in [-1, -1, 0] .. 1,
    over the mesh's ``aabb`` (lo, hi). Its weights start from a generator
    seeded 7, as the JAX package's from ``jax.random.key(7)``."""
    lo = np.asarray([0.0, 0.0, 0.0, 0.0, 0.08, 0.0, -1.0, -1.0, 0.0], np.float32)
    hi = np.ones(9, np.float32)
    gen = torch.Generator(device or 'cpu').manual_seed(7)
    return MLPTexture3D(aabb, channels=channels, min_max=(lo, hi), generator=gen, device=device)


def _material_for_step(cfg: FitConfig, mat: Optional[MLPTexture3D], device=None) -> Material:
    m = default_material(device)
    if not cfg.normal_only and mat is not None:
        m['kd_ks_normal'] = mat
    return m


def rescale_encoder_grads(mat: MLPTexture3D) -> None:
    """Hash-encoder gradients / 8 (reference fit_dmtets.py:486-487): every
    parameter under ``encoder``, in place; the MLP's untouched."""
    for name, p in mat.named_parameters():
        if 'encoder' in name and p.grad is not None:
            p.grad.div_(8.0)


def _count(opt: torch.optim.Optimizer) -> int:
    """Updates an Adam has made (its first parameter's step)."""
    st = opt.state.get(opt.param_groups[0]['params'][0], {})
    return int(st['step']) if 'step' in st else 0


def make_fit_step(fitter: DMTetFitter, cfg: FitConfig, renderer: TargetRenderer,
                  pass_idx: int = 0, init_v_pos: Optional[torch.Tensor] = None,
                  mesh_edges: Optional[torch.Tensor] = None,
                  mat: Optional[MLPTexture3D] = None):
    """The one-iteration fit step of pass 1 (0) or pass 2 (1):

        step(state, light_base, opt_geo, opt_lgt, target, iteration, uniform,
             opt_mat=None, normal=None) -> (state, metrics)

    ``state.sdf`` and ``state.deform`` are the leaves ``opt_geo`` (one
    Adam) updates; they are updated in place and stay the state's leaves.
    ``light_base`` (the cubemap leaf of ``opt_lgt``, a second Adam) is None
    unless ``learn_light``: then its mips are rebuilt inside the loss and
    it is optimized on the material schedule under the reference's x64
    gradient boost, clamped at 0 (fit_dmtets.py:352,424,484-485,516). Each
    Adam's lr comes from its own update count; in pass 2 the sdf gradient
    is zeroed (topology frozen). Unless ``cfg.normal_only``, ``mat`` (the
    neural material, ``opt_mat``'s parameters) shades the candidate and is
    optimized on the material schedule, its encoder's gradient / 8
    (:func:`rescale_encoder_grads`). ``uniform`` supplies the prediction
    surface samples' draws, ``normal`` the material's shading jitter."""
    image_loss_fn = make_image_loss(cfg.loss)
    warmup = 100 if pass_idx == 1 else 0
    lr_geo = lr_schedule(cfg.learning_rate[0], warmup)
    lr_mat = lr_schedule(cfg.learning_rate[1], warmup)
    H, W = cfg.train_res
    cap = None if cfg.shade_cap == 0 else (H * W // 4 if cfg.shade_cap < 0
                                           else min(cfg.shade_cap, H * W))
    material = _material_for_step(cfg, mat, renderer.device)

    def step(state: FitState, light_base, opt_geo, opt_lgt, target: Dict, iteration: int,
             uniform, opt_mat: Optional[torch.optim.Optimizer] = None,
             normal: Optional[Normal] = None):
        for opt, sched in ((opt_geo, lr_geo), (opt_lgt, lr_mat), (opt_mat, lr_mat)):
            if opt is not None:
                opt.param_groups[0]['lr'] = sched(_count(opt))
                opt.zero_grad(set_to_none=True)
        if light_base is not None:
            lgt = light_mod.EnvironmentLight(light_base)
            lgt.build_mips()
        else:
            lgt = renderer.envlight
        caps = dict(raster_K=cfg.raster_K, raster_Kg=cfg.raster_Kg, aa=cfg.antialias,
                    aa_budget=cfg.aa_budget, raster_live=cfg.raster_live, shade_cap=cap,
                    normal=normal)
        if pass_idx == 0:
            img_loss, reg_loss, bufs = fitter.tick(state, material, lgt, target, iteration,
                                                   uniform, image_loss_fn, **caps)
        else:
            img_loss, reg_loss, bufs = fitter.tick_fixed(state, init_v_pos, material, lgt,
                                                         target, iteration, uniform,
                                                         image_loss_fn, mesh_edges, **caps)
        total = img_loss + reg_loss
        total.backward()
        if pass_idx == 1:
            state.sdf.grad.zero_()                 # topology frozen
        opt_geo.step()
        if opt_mat is not None:
            rescale_encoder_grads(mat)
            opt_mat.step()
        if light_base is not None:
            light_base.grad.mul_(64.0)             # reference fit_dmtets.py:484-485
            opt_lgt.step()
            with torch.no_grad():
                light_base.clamp_(min=0.0)         # lgt.clamp_(min=0)

        # state maintenance (reference fit_dmtets.py:501-502 + dmtet.py)
        with torch.no_grad():
            new = state
            if pass_idx == 0:
                new = fitter.shrink_deform(new, iteration)
                new = fitter.carve_occluded(new, target, iteration)
            new = fitter.update_ema(fitter.clamp(new))
            state.sdf.copy_(new.sdf)
            state.deform.copy_(new.deform)
        metrics = {'img_loss': img_loss.detach(), 'reg_loss': reg_loss.detach(),
                   'total': total.detach()}
        for k in ('raster_overflow', 'raster_overflow_global', 'aa_overflow',
                  'raster_overflow_live', 'shade_overflow'):
            metrics[k] = bufs[k]
        return new.replace(sdf=state.sdf, deform=state.deform), metrics

    return step


# the rasterizer's capacities that grow when their overflow counter is set
RASTER_CAPS = (('raster_K', 'raster_overflow'), ('raster_Kg', 'raster_overflow_global'),
               ('raster_live', 'raster_overflow_live'))
# the most fitting grows each to: the JAX package's Pallas z-test carried
# face ids as f32 (exact to 2^24), whence raster_live's cap
_FIT_CAP_MAX = {'raster_K': 4096, 'raster_Kg': 1024, 'raster_live': 2 ** 23}


def fit_one_mesh(mesh_path: str, cfg: FitConfig, out_dir: str, global_index: int,
                 seed: int = 0, device=None) -> Dict[str, str]:
    """Two-pass fit of one mesh; writes the tets_pre/ and tets/ dicts (and
    the validation and baked outputs when asked). Returns their paths:
    'tets_pre', 'tets' and, with ``save_baked``, 'baked' (the .obj)."""
    device = torch.device(device or 'cuda')
    os.makedirs(os.path.join(out_dir, 'tets_pre'), exist_ok=True)
    os.makedirs(os.path.join(out_dir, 'tets'), exist_ok=True)

    ref = obj_mod.load_mesh(mesh_path, device=device)
    aabb = mesh_mod.aabb(ref.v_pos)        # the file's own box: the material's domain
    ref = mesh_mod.center_by_reference(ref, aabb, 1.0)
    ref = mesh_mod.auto_normals(ref)
    if ref.material is None or cfg.normal_only:
        # the reference fits against the default diffuse material when
        # normal_only (fit_dmtets.py:679 use_default=FLAGS.normal_only, mtl at
        # :638-645); else the mesh keeps its own
        ref.material = default_material(device)
    if cfg.learn_light or cfg.envmap is None:
        # when learn_light, the candidate's light is optimized in the fit
        # step; the GT renderer keeps this initial light either way
        envlight = light_mod.create_trainable_env_rnd(512, scale=0.0, bias=0.5, device=device)
        envlight.build_mips()
    else:
        envlight = light_mod.load_env(cfg.envmap, scale=cfg.env_scale, trainable=False,
                                      device=device)

    gen = torch.Generator(device).manual_seed(seed)
    uniform = torch_uniform(gen, device)
    normal = torch_normal(gen, device)
    renderer = TargetRenderer(ref_mesh=ref, envlight=envlight, cam_radius=cfg.cam_radius,
                              train_res=tuple(cfg.train_res), random_lgt=cfg.random_lgt,
                              num_surface_samples=cfg.surface_samples,
                              # a pool larger than the iteration count costs more than it saves
                              target_pool=min(cfg.target_pool, cfg.iter), generator=gen)
    grid = TetGrid.load(cfg.dmtet_grid, cfg.tet_root)
    fitter = DMTetFitter(grid=grid, scale=cfg.mesh_scale, deform_scale=cfg.first_stage_deform,
                         sdf_regularizer=cfg.sdf_regularizer, total_iter=cfg.iter)
    state = fitter.init_state(gen, device)
    mat = None if cfg.normal_only else make_mlp_material(
        tuple(t.cpu().numpy() for t in aabb), device=device)
    np_rng = np.random.default_rng(seed)
    light_base0 = envlight.base.clone() if cfg.learn_light else None

    def run_pass(fitter, state, light_base, pass_idx, init_v_pos=None, mesh_edges=None):
        pass_cfg = cfg
        step = make_fit_step(fitter, pass_cfg, renderer, pass_idx, init_v_pos, mesh_edges, mat)
        # every pass starts its optimizers afresh, as the JAX package does
        opt_mat = None if mat is None else torch.optim.Adam(mat.parameters(), lr=0.0)
        state = state.replace(sdf=state.sdf.detach().clone().requires_grad_(),
                              deform=state.deform.detach().clone().requires_grad_())
        leaves = (state.sdf, state.deform)
        opt_geo = torch.optim.Adam(leaves, lr=0.0)
        opt_lgt = None
        if light_base is not None:
            light_base = light_base.detach().clone().requires_grad_()
            opt_lgt = torch.optim.Adam([light_base], lr=0.0)

        def snapshot(state, it):
            return (state.replace(sdf=state.sdf.detach().clone(),
                                  deform=state.deform.detach().clone()),
                    copy.deepcopy(opt_geo.state_dict()),
                    None if light_base is None else light_base.detach().clone(),
                    None if opt_lgt is None else copy.deepcopy(opt_lgt.state_dict()),
                    None if mat is None else {k: v.detach().clone()
                                              for k, v in mat.state_dict().items()},
                    None if opt_mat is None else copy.deepcopy(opt_mat.state_dict()),
                    gen.get_state(), it)

        def restore(saved):
            st, geo_sd, lb, lgt_sd, mat_sd, opt_mat_sd, rng_state, it = saved
            with torch.no_grad():
                leaves[0].copy_(st.sdf)
                leaves[1].copy_(st.deform)
                if lb is not None:
                    light_base.copy_(lb)
            opt_geo.load_state_dict(geo_sd)
            if lgt_sd is not None:
                opt_lgt.load_state_dict(lgt_sd)
            if mat_sd is not None:
                mat.load_state_dict(mat_sd)
                opt_mat.load_state_dict(opt_mat_sd)
            gen.set_state(rng_state)
            return st.replace(sdf=leaves[0], deform=leaves[1]), it

        def grow_caps(metrics, it):
            """Grow the capacities whose overflow counter is set and rebuild
            the step; True if any grew."""
            nonlocal pass_cfg, step
            over = {k: int(metrics[k]) for k in (
                'raster_overflow', 'raster_overflow_global', 'raster_overflow_live',
                'shade_overflow', 'aa_overflow')}
            updates = {}
            for name, key in RASTER_CAPS:
                hard = _FIT_CAP_MAX[name]
                if over[key] > 0:
                    cur = getattr(pass_cfg, name)
                    if cur >= hard:
                        logger.error('%s at cap %d yet %d dropped at pass%d iter=%d; '
                                     'continuing with clipped rasterization', name, hard,
                                     over[key], pass_idx, it)
                    else:
                        updates[name] = grow_capacity(cur, over[key], hard)
            H, W = pass_cfg.train_res
            if over['shade_overflow'] > 0:
                # ceiling H*W: the compact path then holds every pixel
                cur = H * W // 4 if pass_cfg.shade_cap < 0 else pass_cfg.shade_cap
                updates['shade_cap'] = grow_capacity(cur, over['shade_overflow'], H * W)
            if over['aa_overflow'] > 0:
                cur = pass_cfg.aa_budget or pass_cfg.batch * (H + W) * 8
                updates['aa_budget'] = grow_capacity(cur, over['aa_overflow'], first=2)
            if not updates:
                return False
            logger.warning('capacity overflow %s at pass%d iter=%d: %s (redo)', over, pass_idx,
                           it, {k: (getattr(pass_cfg, k), v) for k, v in updates.items()})
            pass_cfg = dataclasses.replace(pass_cfg, **updates)
            step = make_fit_step(fitter, pass_cfg, renderer, pass_idx, init_v_pos, mesh_edges,
                                 mat)
            return True

        it = dispatched = 0
        # (pre-step snapshot, metrics) of the previously queued step
        pending = None
        t0 = time.perf_counter()
        while True:
            if it >= cfg.iter:
                if pending is not None and grow_caps(pending[1], it - 1):
                    state, it = restore(pending[0])
                    pending = None
                    continue
                break
            saved = snapshot(state, it)
            target = renderer.random_target(cfg.batch, np_rng)
            state, metrics = step(state, light_base, opt_geo, opt_lgt, target, it, uniform,
                                  opt_mat, normal)
            dispatched += 1
            if pending is not None and grow_caps(pending[1], it - 1):
                state, it = restore(pending[0])
                pending = None
                continue
            prev, pending = pending, (saved, metrics)
            if prev is not None and (it - 1) % cfg.log_interval == 0:
                logger.info('pass%d iter=%5d img=%.6f reg=%.6f', pass_idx, it - 1,
                            float(prev[1]['img_loss']), float(prev[1]['reg_loss']),
                            extra={'fit_loss': (pass_idx, it - 1, float(prev[1]['total']))})
            it += 1
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        pass_s = time.perf_counter() - t0
        logger.info('pass%d: %d iterations (%d steps run) in %.3f s', pass_idx, cfg.iter,
                    dispatched, pass_s, extra={'fit_pass': (pass_idx, cfg.iter, dispatched,
                                                            pass_s, renderer.pool_s)})
        return state.replace(sdf=state.sdf.detach(), deform=state.deform.detach()), light_base

    # ---- pass 1
    state, light_base = run_pass(fitter, state, light_base0, pass_idx=0)
    m1 = fitter.get_mesh(state)
    pre_path = os.path.join(out_dir, f'tets_pre/dmt_dict_{global_index:05d}.pt')
    _save_dmt_dict(pre_path, {
        'sdf': state.sdf,
        'sdf_ema': state.sdf_ema,
        'deform': state.deform * m1.valid_vert_idx.float()[:, None],
        'deform_unmasked': state.deform,
    })

    # ---- pass 2: frozen topology, deform rescaled (fit_dmtets.py:761-777)
    fitter2 = FixedTopoFitter(grid=grid, scale=cfg.mesh_scale,
                              deform_scale=cfg.second_stage_deform,
                              laplace_scale=cfg.laplace_scale, total_iter=cfg.iter)
    state2 = fitter2.freeze(state.replace(
        deform=state.deform * cfg.first_stage_deform / cfg.second_stage_deform))
    init_v_pos = fitter2.get_mesh(state2).v_pos.detach()
    # the frozen topology makes the crossing-edge set static: keep the
    # mt-vertex adjacency whose endpoints both exist (host-side, once per mesh)
    occ = state2.sdf.cpu().numpy() > 0
    ue = grid.unique_edges
    crossing = occ[ue[:, 0]] ^ occ[ue[:, 1]]
    adj = _mt_vertex_edges(grid)
    mesh_edges = torch.as_tensor(adj[crossing[adj[:, 0]] & crossing[adj[:, 1]]],
                                 dtype=torch.int64, device=device)
    state2, light_base = run_pass(fitter2, state2, light_base, pass_idx=1,
                                  init_v_pos=init_v_pos, mesh_edges=mesh_edges)
    if light_base is not None:
        # the optimized light for the validation renders
        envlight.base = light_base
        envlight.build_mips()

    m2 = fitter2.get_mesh(state2)
    out_path = os.path.join(out_dir, f'tets/dmt_dict_{global_index:05d}.pt')
    _save_dmt_dict(out_path, {
        'sdf': state2.sdf,
        'deform': state2.deform * m2.valid_vert_idx.float()[:, None],
        'deform_unmasked': state2.deform,
    })
    paths = {'tets_pre': pre_path, 'tets': out_path}
    if cfg.validate:
        # PSNR / MSE validation renders (reference fit_dmtets.py:795-796)
        from .validate import validate
        validate(fitter2, state2, renderer,
                 os.path.join(out_dir, f'val_viz/dmtet_validate_{global_index}'),
                 num_views=cfg.validate_views, raster_K=cfg.raster_K)
    if cfg.save_baked and mat is not None:
        # UV-unwrap the fitted mesh and bake the material into textures
        # (reference eval.py:96-128 xatlas_uvmap + obj export)
        from .export import export_baked
        faces = m2.t_pos_idx[m2.face_mask]
        used = torch.zeros(m2.v_pos.shape[0], dtype=torch.bool, device=device)
        used[faces.reshape(-1)] = True
        remap = torch.cumsum(used.long(), 0) - 1
        m_host = mesh_mod.auto_normals(mesh_mod.Mesh(v_pos=m2.v_pos.detach()[used],
                                                     t_pos_idx=remap[faces]))
        with torch.no_grad():
            paths['baked'] = export_baked(m_host, mat,
                                          os.path.join(out_dir, f'baked/{global_index:05d}'))
    return paths


def _mt_vertex_edges(grid: TetGrid) -> np.ndarray:
    """Adjacency between marching-tets vertices (one per unique tet edge):
    two are connected when their tet edges co-occur in a tet."""
    t2e = grid.tet_edge_to_unique                      # (T, 6)
    pairs = [np.stack([t2e[:, i], t2e[:, j]], axis=1)
             for i in range(6) for j in range(i + 1, 6)]
    e = np.sort(np.concatenate(pairs, axis=0), axis=1)
    return np.unique(e, axis=0).astype(np.int32)


def _save_dmt_dict(path: str, d: Dict[str, torch.Tensor]) -> str:
    torch.save({k: v.detach().float().cpu().contiguous() for k, v in d.items()}, path)
    return path
