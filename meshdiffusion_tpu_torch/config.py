"""Configuration tree, as plain Python.

Same tree and keys as ``meshdiffusion_tpu/config.py`` (the reference's
``configs/default_configs.py`` specialised by ``configs/res64.py`` and
``configs/res128.py``), without ``ml_collections``: a :class:`Config` is a
dict with attribute access, so dotted overrides such as
``--config.eval.ckpt_path=...`` work as before. The TPU section is
replaced by a ``gpu`` section that holds only what this package reads.
"""

from __future__ import annotations

from typing import Any, Iterable, Tuple


class Config(dict):
    """A dict whose keys are also attributes; nested sections are Configs."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


def get_default_config() -> Config:
    """Base tree; key parity with the JAX package's ``get_default_config``."""
    config = Config()

    config.training = Config(
        batch_size=64, n_iters=2400001, snapshot_freq=50000, log_freq=50,
        eval_freq=100, snapshot_freq_for_preemption=5000,
        snapshot_sampling=True, likelihood_weighting=False, continuous=True,
        reduce_mean=False, iter_size=1, loss_type='l2',
        train_dir="PLACEHOLDER", sde='vpsde', lip_scale=None)

    config.sampling = Config(
        n_steps_each=1, noise_removal=True, probability_flow=False, snr=0.075,
        method='pc', predictor='ancestral_sampling', corrector='none')

    config.eval = Config(
        begin_ckpt=50, end_ckpt=96, batch_size=512, enable_sampling=True,
        num_samples=50000, enable_loss=True, enable_bpd=False,
        bpd_dataset='test', ckpt_path="PLACEHOLDER",
        partial_dmtet_path="PLACEHOLDER", tet_path="PLACEHOLDER",
        freeze_iters=950, eval_dir="PLACEHOLDER")

    config.data = Config(
        dataset='ShapeNet', image_size=64, random_flip=True,
        uniform_dequantization=False, centered=True, num_channels=4,
        num_workers=4, normalize_sdf=True, meta_path="PLACEHOLDER",
        filter_meta_path="PLACEHOLDER", extension='npy', aug=True,
        grid_mask_path="")  # '' -> derived from the tet grid at run time

    config.model = Config(
        name='ddpm_res64', sigma_max=378, sigma_min=0.01, num_scales=1000,
        beta_min=0.1, beta_max=20., dropout=0.1, embedding_type='fourier',
        deform_scale=1.0, scale_by_sigma=False, ema_rate=0.9999,
        normalization='GroupNorm', nonlinearity='swish', nf=128,
        ch_mult=(1, 1, 2, 4, 4), num_res_blocks_first=2, num_res_blocks=3,
        attn_resolutions=(16,), resamp_with_conv=True, conditional=True)

    config.optim = Config(
        weight_decay=0, optimizer='Adam', lr=2e-4, beta1=0.9, eps=1e-8,
        warmup=5000, grad_clip=1.)

    config.seed = 42
    config.render = Config()

    config.gpu = Config(
        compute_dtype='bfloat16',  # conv/matmul compute dtype
        tet_root="",               # dir holding {R}_tets_cropped.npz; '' -> bundled
        mesh_data_axis=-1,         # ranks along the batch; -1: every rank left
        mesh_spatial_axis=1,       # ranks along the grid's depth
        allow_device_idle=False,   # shrink the data axis to a divisor of the batch
        # each ResnetBlock under torch.utils.checkpoint in the train forward
        # (recomputed in the backward); res64 needs it to fit a micro-batch
        remat_blocks=True,
        dist_backend='nccl')       # 'gloo' on the CPU and where ranks share a card
    return config


def get_res64_config() -> Config:
    """res64 preset (reference configs/res64.py)."""
    config = get_default_config()
    config.training.continuous = False
    config.training.reduce_mean = True
    config.training.batch_size = 48
    config.training.snapshot_freq_for_preemption = 1000
    config.data.image_size = 64
    config.model.name = 'ddpm_res64'
    config.model.num_res_blocks = 3
    config.model.ch_mult = (1, 1, 2, 4, 4)
    config.model.dropout = 0.1
    config.optim.lr = 2e-5
    config.eval.batch_size = 4
    return config


def get_res128_config() -> Config:
    """res128 preset (reference configs/res128.py; 'ddpm_res128_v2' and
    'ddpm_res128' name the same architecture, see models/unet3d.py)."""
    config = get_default_config()
    config.training.continuous = False
    config.training.reduce_mean = True
    config.training.batch_size = 8
    config.training.iter_size = 4
    config.training.snapshot_freq_for_preemption = 1000
    config.data.image_size = 128
    config.data.num_workers = 8
    config.model.name = 'ddpm_res128'
    config.model.num_res_blocks = 2
    config.model.num_res_blocks_first = 2
    config.model.ch_mult = (1, 1, 2, 4, 4, 4)
    config.model.dropout = 0.1
    config.optim.lr = 7e-5 / config.training.iter_size * 2.0
    config.eval.batch_size = 7
    return config


def get_dit3d_xl4_res64_config() -> Config:
    """The res64 preset's data, SDE, sampling and eval sections with the 3D
    diffusion transformer in the U-Net's place (``models/dit3d.py``): DiT-XL/4
    (facebookresearch/DiT ``DiT_XL_4``: hidden 1152, depth 28, 16 heads,
    MLP ratio 4, patch 4) over 4^3 patches of the 64^3 grid, 4096 tokens.
    The U-Net's keys of the model section stay, unread."""
    config = get_res64_config()
    m = config.model
    m.name = 'dit3d_xl4'
    m.hidden_size = 1152
    m.depth = 28
    m.num_heads = 16
    m.mlp_ratio = 4.0
    m.patch_size = 4
    return config


def get_dit3d_moe_xl4_res64_config() -> Config:
    """``dit3d_xl4_res64`` with every block's MLP replaced by DiT-MoE's
    sparse-expert layer (feizc/DiT-MoE ``DiT-MoE-XL/2-8E2A`` in 4^3 3D
    patches, ``models/moe.py``): 8 SwiGLU experts of width 4608 (mlp_ratio x
    hidden), the top 2 a token, and a shared SwiGLU expert of width 2304
    (2 x hidden)."""
    config = get_dit3d_xl4_res64_config()
    m = config.model
    m.name = 'dit3d_moe_xl4'
    m.num_experts = 8
    m.experts_per_token = 2
    m.expert_hidden = 4608
    m.shared_expert_hidden = 2304
    return config


def get_flux3d_dev_res64_config() -> Config:
    """The res64 preset's data, SDE, sampling and eval sections with FLUX.1's
    MMDiT in the U-Net's place (``models/flux3d.py``): the widths of
    black-forest-labs/flux ``configs["flux-dev"]`` (hidden 3072, 24 heads of
    128, MLP ratio 4, ``axes_dim`` (16, 56, 56), theta 10,000, qkv bias,
    guidance embedding, T5 features of 4096 over 512 tokens, a pooled vector
    of 768) over 4^3 patches of the 64^3 grid, 4096 tokens, with the first
    10 of its 19 double-stream and 20 of its 38 single-stream blocks: the
    whole model's fp32 weights beside their bf16 copies, as the port's
    ``Linear`` keeps them, would not fit one card. The condition comes from
    ``eval.condition_path`` (a torch file of ``txt``, ``y`` and
    ``guidance``) or, where that is empty, standard normal features drawn
    from the seed at ``model.guidance`` (3.5, FLUX-dev's default). The
    U-Net's keys of the model section stay, unread."""
    config = get_res64_config()
    m = config.model
    m.name = 'flux3d'
    m.hidden_size = 3072
    m.num_heads = 24
    m.mlp_ratio = 4.0
    m.depth = 10
    m.depth_single_blocks = 20
    m.axes_dim = (16, 56, 56)
    m.theta = 10000
    # FLUX-dev's published values, stated for the record: Flux3D always has
    # the qkv biases and the guidance embedder
    m.qkv_bias = True
    m.guidance_embed = True
    m.context_in_dim = 4096
    m.context_len = 512
    m.vec_in_dim = 768
    m.patch_size = 4
    m.guidance = 3.5
    config.eval.condition_path = ''
    return config


_PRESETS = {
    'res64': get_res64_config,
    'res128': get_res128_config,
    'dit3d_xl4_res64': get_dit3d_xl4_res64_config,
    'dit3d_moe_xl4_res64': get_dit3d_moe_xl4_res64_config,
    'flux3d_dev_res64': get_flux3d_dev_res64_config,
    'default': get_default_config,
}


PRESETS = tuple(_PRESETS)


def get_config(name: str = 'res64') -> Config:
    try:
        return _PRESETS[name]()
    except KeyError as e:
        raise ValueError(f"unknown config preset {name!r}; have {sorted(_PRESETS)}") from e


def apply_overrides(config: Config, overrides: Iterable[Tuple[str, str]]) -> Config:
    """Apply dotted ``('a.b', 'value')`` overrides, parsing each value as the
    type of the value it replaces."""
    for key, val in overrides:
        node = config
        parts = key.split('.')
        for p in parts[:-1]:
            node = getattr(node, p)
        old = getattr(node, parts[-1])
        if isinstance(old, bool):
            val = val.lower() in ('1', 'true', 'yes')
        elif isinstance(old, int):
            val = int(val)
        elif isinstance(old, float):
            val = float(val)
        elif isinstance(old, tuple):
            val = tuple(int(x) for x in val.strip('()').split(',') if x)
        setattr(node, parts[-1], val)
    return config
