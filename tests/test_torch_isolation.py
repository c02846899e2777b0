"""The port stands alone: ``meshdiffusion_tpu_torch`` and its entry point
import no jax, flax, ml_collections or JAX package, and its command line
runs its slices on the CPU: uncond_gen -> extract, fit_dmtets,
fit_singleview -> cond_gen (with uncond_gen --traj and uncond_gen_interp),
train (in one process, and in two on a (1, 2) rank mesh), and the data tools with extract --save_viz on a generated grid, in
a process where the JAX modules cannot be imported."""

import json
import os
import pathlib
import re
import struct
import subprocess
import sys

import numpy as np
import torch

pytest_plugins = ('torch_rules',)

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ml_collections', 'meshdiffusion_tpu')

_CHILD = r'''
import sys
from meshdiffusion_tpu_torch.main import main
out = sys.argv[1]
npy = main(['--mode', 'uncond_gen', '--device', 'cpu', '--config', 'res64',
            '--config.model.nf=32', '--config.model.ch_mult=(1,2,2,2)',
            '--config.model.num_res_blocks=1', '--config.model.attn_resolutions=(8,)',
            '--config.model.num_scales=3', '--config.model.beta_max=2.0',
            '--config.eval.batch_size=1', '--config.eval.eval_dir=' + out])
objs = main(['--mode', 'extract', '--device', 'cpu', '--sample_path', npy,
             '--out_dir', out, '--no_remesh'])
bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)
print('RESULT', npy, objs[0], bad)
''' % (FORBIDDEN,)


def test_cli_slice_runs_without_jax(tmp_path):
    """A tiny-width res64 model on the real 64 tet grid mask: 2 sampler
    steps, then marching tets + smoothing to .obj, in a fresh process."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', _CHILD, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith('RESULT')][-1]
    _, npy, obj, bad = line.split(' ', 3)
    assert bad == '[]', bad
    sample = np.load(npy)
    assert sample.shape == (1, 4, 64, 64, 64) and np.isfinite(sample).all()
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    mask = TetGrid.load(64).grid_mask()
    assert (sample[0] * (1 - mask)).any() == False  # noqa: E712  zero outside the grid mask
    text = pathlib.Path(obj).read_text()
    assert text.count('\nf ') > 0


_FIT_CHILD = r'''
import importlib, json, pkgutil, sys
import meshdiffusion_tpu_torch
for m in pkgutil.walk_packages(meshdiffusion_tpu_torch.__path__, 'meshdiffusion_tpu_torch.'):
    importlib.import_module(m.name)
from meshdiffusion_tpu_torch.main import main
out = sys.argv[1]
written = main(['--mode', 'fit_dmtets', '--device', 'cpu', '--meta_path', out + '/meshes.json',
                '--out_dir', out + '/fit', '--fit_config', out + '/fit.json', '--iter', '3',
                '--batch', '2'])
bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)
print('RESULT', json.dumps({'written': written, 'bad': bad}))
''' % (FORBIDDEN,)


def _write_tiny_grid_and_sphere(tmp_path):
    """An 8^3 Kuhn tet grid as ``tmp_path/8_tets_cropped.npz``, a sphere
    ``.obj`` marched on it, ``meshes.json`` and a 48^2 ``fit.json``;
    returns the grid."""
    from meshdiffusion_tpu_torch.geometry.marching_tets import compact_mesh, marching_tets
    from meshdiffusion_tpu_torch.geometry.obj_io import write_obj
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    n = 8
    xs = np.linspace(-0.45, 0.45, n, dtype=np.float32)
    verts = np.stack(np.meshgrid(xs, xs, xs, indexing='ij'), -1).reshape(-1, 3)
    vid = np.arange(n ** 3).reshape(n, n, n)
    c = [vid[i:n - 1 + i, j:n - 1 + j, k:n - 1 + k].reshape(-1)
         for k in (0, 1) for j in (0, 1) for i in (0, 1)]          # cube corners 0..7
    kuhn = [(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7), (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7)]
    tets = np.stack([np.stack([c[a] for a in t], 1) for t in kuhn], 1).reshape(-1, 4)
    np.savez(tmp_path / f'{n}_tets_cropped.npz', vertices=verts, indices=tets.astype(np.int32))
    grid = TetGrid.load(n, str(tmp_path))
    sdf = 0.3 - np.linalg.norm(grid.verts, axis=1).astype(np.float32)
    v, f = compact_mesh(marching_tets(grid, torch.from_numpy(grid.verts), torch.from_numpy(sdf)))
    write_obj(str(tmp_path / 'sphere.obj'), v, f)
    (tmp_path / 'meshes.json').write_text(json.dumps([str(tmp_path / 'sphere.obj')]))
    (tmp_path / 'fit.json').write_text(json.dumps({
        'train_res': [48, 48], 'dmtet_grid': n, 'tet_root': str(tmp_path), 'mesh_scale': 1.0,
        'surface_samples': 1000, 'cam_radius': 2.0, 'target_pool': 2}))
    return grid


def test_fit_cli_runs_without_jax(tmp_path):
    """Every module of the package imports without jax; then ``main --mode
    fit_dmtets --device cpu`` fits a sphere on an 8^3 tet grid (written
    where ``tet_root`` points) for 3 iterations a pass at 48^2, batch 2:
    both dicts, with the JAX package's keys and shapes, signs in pass 2."""
    grid = _write_tiny_grid_and_sphere(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', _FIT_CHILD, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith('RESULT')][-1]
    result = json.loads(line.split(' ', 1)[1])
    assert result['bad'] == [], result['bad']
    (paths,) = result['written']
    V = grid.num_verts
    pre, fin = torch.load(paths['tets_pre']), torch.load(paths['tets'])
    assert set(pre) == {'sdf', 'sdf_ema', 'deform', 'deform_unmasked'}
    assert set(fin) == {'sdf', 'deform', 'deform_unmasked'}
    for d in (pre, fin):
        assert d['sdf'].shape == (V,) and d['deform'].shape == (V, 3)
        assert d['deform_unmasked'].shape == (V, 3)
        assert all(torch.isfinite(t).all() for t in d.values())
    assert set(fin['sdf'].unique().tolist()) <= {-1.0, 1.0}
    assert (fin['sdf'] > 0).any() and (fin['sdf'] < 0).any()


_COND_CHILD = r'''
import sys
for name in %r:
    sys.modules[name] = None          # importing any of them now raises
from meshdiffusion_tpu_torch.config import apply_overrides, get_config
from meshdiffusion_tpu_torch.main import main
from meshdiffusion_tpu_torch.models import create_model
from meshdiffusion_tpu_torch.utils.checkpoint import EMA, save_checkpoint
import torch
out = sys.argv[1]
dmtet = main(['--mode', 'fit_singleview', '--device', 'cpu', '--meta_path', out + '/sphere.obj',
              '--out_dir', out + '/sv', '--fit_config', out + '/fit.json', '--iter', '3',
              '--angle_ind', '10'])
tiny = ['--config.data.image_size=8', '--config.gpu.tet_root=' + out, '--config.model.nf=32',
        '--config.model.ch_mult=(1,2)', '--config.model.num_res_blocks=1',
        '--config.model.attn_resolutions=(4,)', '--config.model.num_scales=3',
        '--config.model.beta_max=2.0', '--config.gpu.compute_dtype=float32']
cfg = apply_overrides(get_config('res64'), [a[len('--config.'):].split('=', 1) for a in tiny])
model = create_model(cfg, device='cpu', generator=torch.Generator().manual_seed(0))
ckpt = save_checkpoint(out + '/ckpt.pth', {'model': model, 'ema': EMA(model), 'step': 7}, cfg)
cond = main(['--mode', 'cond_gen', '--device', 'cpu', *tiny, '--config.eval.batch_size=1',
             '--config.eval.ckpt_path=' + ckpt, '--config.eval.partial_dmtet_path=' + dmtet,
             '--config.eval.freeze_iters=2', '--config.eval.eval_dir=' + out + '/gen'])
traj = main(['--mode', 'uncond_gen', '--traj', '--device', 'cpu', *tiny,
             '--config.eval.batch_size=1', '--config.eval.eval_dir=' + out + '/traj'])
interp = main(['--mode', 'uncond_gen_interp', '--device', 'cpu', *tiny,
               '--config.eval.batch_size=3', '--config.eval.ckpt_path=' + ckpt,
               '--config.eval.eval_dir=' + out + '/interp'])
print('RESULT', dmtet, cond, traj[0], interp)
''' % (FORBIDDEN,)


def test_cond_cli_runs_without_jax(tmp_path):
    """In a process where jax, flax and the JAX package cannot be imported:
    ``main --mode fit_singleview --device cpu`` fits one view of a sphere on
    the 8^3 tet grid (3 iterations at 48^2) and writes the dict
    {sdf, deform, vis, vis_rast}; a tiny U-Net saved by ``save_checkpoint``
    then conditions ``main --mode cond_gen`` on it; ``uncond_gen --traj``
    and ``uncond_gen_interp`` (batch 3) run too."""
    grid = _write_tiny_grid_and_sphere(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', _COND_CHILD, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith('RESULT')][-1]
    _, dmtet, cond, traj, interp = line.split(' ')
    d = torch.load(dmtet)
    V = grid.num_verts
    assert set(d) == {'sdf', 'deform', 'vis', 'vis_rast'}
    assert d['sdf'].shape == d['vis'].shape == d['vis_rast'].shape == (V,)
    assert d['deform'].shape == (V, 3) and d['vis_rast'].dtype == torch.bool
    assert set(d['sdf'].unique().tolist()) <= {-1.0, 1.0}
    assert 0 < d['vis'].sum() < V and bool((d['vis_rast'] >= (d['vis'] > 0)).all())
    mask = grid.grid_mask()
    for path, batch in ((cond, 1), (traj, 1), (interp, 3)):
        sample = np.load(path)
        assert sample.shape == (batch, 4, 8, 8, 8) and np.isfinite(sample).all()
        assert not (sample * (1 - mask)).any()
    assert np.abs(np.load(cond)).max() > 0 and np.abs(np.load(interp)).max() > 0


_TRAIN_CHILD = r'''
import importlib, json, pkgutil, sys


class Forbidden:
    """Refuses the JAX modules, so that an import of one anywhere in the
    run fails here."""
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in %r:
            raise ImportError('forbidden here: ' + name)


if sys.argv[2] == 'block':
    sys.meta_path.insert(0, Forbidden())
import meshdiffusion_tpu_torch
for m in pkgutil.walk_packages(meshdiffusion_tpu_torch.__path__, 'meshdiffusion_tpu_torch.'):
    importlib.import_module(m.name)
for name in ('data.dataset', 'native.grid_loader', 'diffusion.losses', 'diffusion.trainer'):
    assert 'meshdiffusion_tpu_torch.' + name in sys.modules, name
from meshdiffusion_tpu_torch.main import main
out = sys.argv[1]
state = main(['--mode', 'train', '--device', 'cpu', '--config', 'res64',
              '--config.data.image_size=8', '--config.data.meta_path=' + out + '/meta.json',
              '--config.data.grid_mask_path=' + out + '/mask.npy', '--config.data.num_workers=2',
              '--config.model.nf=32', '--config.model.ch_mult=(1,2)',
              '--config.model.num_res_blocks=1', '--config.model.attn_resolutions=(4,)',
              '--config.model.num_scales=10', '--config.model.beta_max=2.0',
              '--config.training.batch_size=2', '--config.training.iter_size=2',
              '--config.training.n_iters=2', '--config.training.log_freq=1',
              '--config.training.train_dir=' + out + '/run', '--config.gpu.compute_dtype=float32'])
bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)
print('RESULT', json.dumps({'step': state.step, 'bad': bad}))
''' % (FORBIDDEN, FORBIDDEN + ('tensorflow',))


def _train_child(tmp_path, block: bool) -> dict:
    """Runs ``_TRAIN_CHILD`` on four random 8^3 grids and an all-ones mask
    in ``tmp_path``, the JAX modules refused where ``block``; its RESULT."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        g = rng.normal(size=(4, 8, 8, 8)).astype(np.float32)
        paths.append(str(tmp_path / f'grid_{i:05d}.npy'))
        np.save(paths[-1], g)
    (tmp_path / 'meta.json').write_text(json.dumps(paths))
    np.save(tmp_path / 'mask.npy', np.ones((8, 8, 8), np.float32))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', _TRAIN_CHILD, str(tmp_path),
                           'block' if block else 'open'], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith('RESULT')][-1]
    return json.loads(line.split(' ', 1)[1])


def test_train_cli_runs_without_jax(tmp_path):
    """``main --mode train --device cpu`` at a tiny width on 8^3 grids, in a
    process where jax and the JAX package cannot be imported: steps 0..2,
    a finite loss logged each step, the last snapshot written."""
    result = _train_child(tmp_path, block=True)
    assert result == {'step': 3, 'bad': []}
    lines = [json.loads(ln) for ln in (tmp_path / 'run' / 'metrics.jsonl').read_text().splitlines()]
    assert [ln['step'] for ln in lines] == [0, 1, 2]
    assert all(np.isfinite(ln['value']) for ln in lines)
    assert (tmp_path / 'run' / 'checkpoints' / 'checkpoint_3.pth').exists()


def test_train_leaves_jax_out_of_the_process(tmp_path):
    """The same run with nothing refused, where jax, the JAX package and
    TensorFlow are installed: none of them is in ``sys.modules`` after
    ``train``, TensorBoard's writer included, which still writes its
    event file."""
    result = _train_child(tmp_path, block=False)
    assert result == {'step': 3, 'bad': []}
    events = list((tmp_path / 'run' / 'tensorboard').glob('events.out.tfevents.*'))
    assert len(events) == 1 and events[0].stat().st_size > 0


_DIST_TRAIN_CHILD = r'''
import hashlib, json, sys


class Forbidden:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in %r:
            raise ImportError('forbidden here: ' + name)


sys.meta_path.insert(0, Forbidden())
from meshdiffusion_tpu_torch.main import main
out = sys.argv[1]
state = main(['--mode', 'train', '--device', 'cpu', '--config', 'res64',
              '--config.data.image_size=8', '--config.data.meta_path=' + out + '/meta.json',
              '--config.data.grid_mask_path=' + out + '/mask.npy', '--config.data.num_workers=2',
              '--config.model.nf=32', '--config.model.ch_mult=(1,2)',
              '--config.model.num_res_blocks=1', '--config.model.attn_resolutions=(4,)',
              '--config.model.num_scales=10', '--config.model.beta_max=2.0',
              '--config.training.batch_size=2', '--config.training.iter_size=2',
              '--config.training.n_iters=2', '--config.training.log_freq=1',
              '--config.training.train_dir=' + out + '/run', '--config.gpu.compute_dtype=float32',
              '--config.gpu.dist_backend=gloo', '--config.gpu.mesh_spatial_axis=2'])
digest = hashlib.sha256()
for p in state.model.parameters():
    digest.update(p.detach().numpy().tobytes())
bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)
print('RESULT', json.dumps({'step': state.step, 'digest': digest.hexdigest(), 'bad': bad}))
''' % (FORBIDDEN, FORBIDDEN)


def test_two_rank_train_cli_runs_without_jax(tmp_path):
    """``main --mode train --device cpu`` in two processes joined by the
    MESHDIFFUSION_* variables (gloo, mesh (1, 2): each rank holds half of
    every grid's depth), the JAX modules refused: both exit 0 after steps
    0..2, rank 0 alone writes the metrics and the one snapshot, and both
    ranks hold bit-equal weights."""
    import socket
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f'grid_{i:05d}.npy'))
        np.save(paths[-1], rng.normal(size=(4, 8, 8, 8)).astype(np.float32))
    (tmp_path / 'meta.json').write_text(json.dumps(paths))
    np.save(tmp_path / 'mask.npy', (rng.random((8, 8, 8)) > 0.2).astype(np.float32))
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   MESHDIFFUSION_COORDINATOR=f'localhost:{port}', MESHDIFFUSION_NUM_PROCESSES='2',
                   MESHDIFFUSION_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, '-c', _DIST_TRAIN_CHILD, str(tmp_path)],
                                      cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    results = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {rank}:\n{err[-3000:]}'
        line = [ln for ln in out.splitlines() if ln.startswith('RESULT')][-1]
        results.append(json.loads(line.split(' ', 1)[1]))
    assert [r['step'] for r in results] == [3, 3] and [r['bad'] for r in results] == [[], []]
    assert results[0]['digest'] == results[1]['digest']
    assert sorted(os.listdir(tmp_path / 'run' / 'checkpoints')) == ['checkpoint_3.pth']
    lines = [json.loads(ln) for ln in (tmp_path / 'run' / 'metrics.jsonl').read_text().splitlines()]
    assert [ln['step'] for ln in lines] == [0, 1, 2]
    assert all(np.isfinite(ln['value']) for ln in lines)


_TOOLS_CHILD = r'''
import json, runpy, sys


class Forbidden:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in %r:
            raise ImportError('forbidden here: ' + name)


sys.meta_path.insert(0, Forbidden())
import numpy as np
out = sys.argv[1]


def convert(*args):
    sys.argv = ['convert', *args]
    runpy.run_module('meshdiffusion_tpu_torch.data.convert', run_name='__main__')


convert('tets-to-3dgrid', '-res', '8', '-s', out + '/tets', '-t', out + '/grids',
        '--tet-root', out, '--device', 'cpu')
convert('get-tet-mask', '--resolution', '8', '--tet-root', out, '--out', out + '/mask.npy')
convert('save-meta', '--data-dir', out + '/grids', '--out', out + '/meta.json')
from meshdiffusion_tpu_torch.main import main
objs = main(['--mode', 'extract', '--device', 'cpu', '--sample_path', out + '/sphere16.npy',
             '--out_dir', out + '/ex', '--resolution', '16', '--save_viz', '--angle_ind', '10',
             '--no_remesh'])
bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)
print('RESULT', json.dumps({'objs': objs, 'bad': bad}))
''' % (FORBIDDEN, FORBIDDEN)


def test_data_tools_and_viz_run_without_jax(tmp_path):
    """``python -m meshdiffusion_tpu_torch.data.convert`` (tets-to-3dgrid on
    the CPU, get-tet-mask, save-meta) on the 8^3 grid, then ``main --mode
    extract --save_viz`` at resolution 16, whose grid has no asset and is
    generated and cached (under ``XDG_CACHE_HOME``), writing the mesh and
    ``viz/viz_000000.png`` at 512^2, as the JAX CLI renders it: all with
    the JAX modules refused."""
    grid = _write_tiny_grid_and_sphere(tmp_path)
    (tmp_path / 'tets').mkdir()
    sdf = np.sign(0.3 - np.linalg.norm(grid.verts, axis=1)).astype(np.float32)
    np.savez(tmp_path / 'tets' / 'dmt_dict_00000.npz', sdf=sdf,
             deform=np.zeros((grid.num_verts, 3), np.float32))
    c = (np.arange(16) - 7.5) / 16
    d = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
    sample = np.zeros((1, 4, 16, 16, 16), np.float32)
    sample[0, 0] = 0.3 - d
    np.save(tmp_path / 'sphere16.npy', sample)
    env = dict(os.environ, PYTHONPATH=str(REPO), XDG_CACHE_HOME=str(tmp_path / 'cache'))
    proc = subprocess.run([sys.executable, '-c', _TOOLS_CHILD, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith('RESULT')][-1]
    result = json.loads(line.split(' ', 1)[1])
    assert result['bad'] == []
    g = np.load(tmp_path / 'grids' / 'grid_00000.npy')
    assert g.shape == (4, 8, 8, 8)
    c = grid.vert_grid_coords
    np.testing.assert_array_equal(g[0][c[:, 0], c[:, 1], c[:, 2]], sdf)
    np.testing.assert_array_equal(np.load(tmp_path / 'mask.npy'), grid.grid_mask())
    assert json.loads((tmp_path / 'meta.json').read_text()) == [str(tmp_path / 'grids' /
                                                                    'grid_00000.npy')]
    assert (tmp_path / 'cache' / 'meshdiffusion_tpu_torch' / 'tetgrid_gen_16.npz').exists()
    assert [os.path.relpath(p, tmp_path / 'ex') for p in result['objs']] == ['mesh/000000.obj']
    assert pathlib.Path(result['objs'][0]).read_text().count('\nf ') > 10
    png = (tmp_path / 'ex' / 'viz' / 'viz_000000.png').read_bytes()
    assert png.startswith(b'\x89PNG') and len(png) > 2000
    assert struct.unpack('>II', png[16:24]) == (512, 512)


def test_sources_import_nothing_of_jax():
    pattern = re.compile(r'^\s*(import|from)\s+(%s)\b' % '|'.join(FORBIDDEN), re.M)
    files = sorted((REPO / 'meshdiffusion_tpu_torch').rglob('*.py')) + [
        REPO / 'chip_smoke.py', REPO / 'zmin_compare.py', REPO / 'material_compare.py']
    assert len(files) > 10
    names = {str(f.relative_to(REPO)) for f in files}
    assert {'meshdiffusion_tpu_torch/data/convert.py', 'meshdiffusion_tpu_torch/extract.py',
            'meshdiffusion_tpu_torch/diffusion/likelihood.py',
            'meshdiffusion_tpu_torch/geometry/generate_tets.py',
            'meshdiffusion_tpu_torch/utils/debug.py', 'meshdiffusion_tpu_torch/models/ncsn_blocks.py',
            'meshdiffusion_tpu_torch/models/normalization.py',
            'meshdiffusion_tpu_torch/models/up_or_down_sampling.py'} <= names
    for f in files:
        assert not pattern.search(f.read_text()), f
