"""Build and load the package's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (Hopper) at first use,
one process per source, all started together, and links the objects into
one shared library with a plain C interface. The library goes to
``meshdiffusion_tpu_torch/_build/`` under a name keyed on a hash of the
sources, the headers they share (``csrc/*.cuh``) and the flags, so a
changed source rebuilds and an unchanged one loads at once. It is loaded with ``ctypes``; every pointer and the stream are
passed as ``c_void_p``, sizes as ``c_int``, and every entry point returns
``cudaGetLastError()`` after its launches, which :func:`check` turns into an
exception. Loading it, and building it first where it is missing, counts
as ``rebuild.nvcc`` (``utils/trace.py``); :func:`watch_triton_compiles`
counts each Triton specialization compiled as ``rebuild.triton``.

There is no prebuilt library and no fallback: without ``nvcc`` the build
raises.

The route rule. Every kernel wrapper of ``ops`` is declared by
:func:`kernel_wrapper`, which alone decides how a call runs: its plain
version (``*_reference``, which takes the wrapper's own arguments), its
kernel, or its kernel forward with the plain version's backward. In order:

1. Gradient. Where autograd would record the call (grad mode on and some
   tensor argument requires grad), the wrapper's declared backward
   decides: :class:`PlainBackward` (the conv kernel in both its modes) runs
   the call as routed below and differentiates the plain version,
   recomputed, in the backward; ``gn_moments`` keeps its own exact
   backward; a wrapper that declares none runs its plain version.
2. Device (:func:`use_kernel`): CPU tensors to the plain version, CUDA
   tensors to the kernel, anything else raises. Within :func:`plain` every
   call takes the plain version: the plain comparisons on the card.

Each call, on any route, is an ``ops.<wrapper>`` span (``utils/trace.py``);
each wrapper counts its kernel launches in ``.launches``, and
:data:`KERNEL_WRAPPERS` lists every wrapper declared.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import glob
import hashlib
import inspect
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from ..utils import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
ARCH_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a']
FLAGS = ['-O3', '-std=c++17', '-Xcompiler', '-fPIC', '-lineinfo']

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argtypes (restype is int: a cudaError_t)
_SIGNATURES = {
    # x, a, b, w, bias, out, partial, B, D, H, W, C, O, tiling, route, TD, TH, TW, splits,
    # grid, lo, hi, stream
    'gn_silu_conv3d_bf16': [_P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, dtype, scale, bias, a, b, work, ticket, xb, moments, B, S, C, G, CC, R, eps, stream
    'gn_stats': [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # coords, tile_tris, tile_counts, global_tris, global_count, z_floor, order, best_tri,
    # best_z, N, F, K, Kg, ntx, tpv, H, W, layers, stream
    'tile_zmin': [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, x_bf16, w, bias, h, out, M, K, N, stream
    'nin_residual_bf16': [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    # qkv, out, B, T, H, dh, stream
    'dit_attention_bf16': [_P, _P, _I, _I, _I, _I, _P],
    # x, w_gu, w_down, order, offsets, weights, h, out, rows, D, F, E, k, stream
    'moe_experts_bf16': [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, T1, stride1, x2, T2, stride2, q_scale, k_scale, q_scale2, k_scale2, pe, out, B, H, dh,
    # stream
    'qk_norm_rope_bf16': [_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_log = ''


def _nvcc() -> str:
    for cand in (os.environ.get('NVCC'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc'),
                 shutil.which('nvcc')):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels of meshdiffusion_tpu_torch '
                       'need the CUDA toolkit (set CUDA_HOME or NVCC)')


def _sources():
    srcs = sorted(glob.glob(os.path.join(SRC_DIR, '*.cu')))
    if not srcs:
        raise RuntimeError(f'no CUDA sources under {SRC_DIR}')
    return srcs


def library_path() -> str:
    h = hashlib.sha256(' '.join(ARCH_FLAGS + FLAGS).encode())
    for s in _sources() + sorted(glob.glob(os.path.join(SRC_DIR, '*.cuh'))):
        with open(s, 'rb') as f:
            h.update(os.path.basename(s).encode() + f.read())
    return os.path.join(BUILD_DIR, f'libmdt_kernels_{h.hexdigest()[:16]}.so')


def build(verbose: bool = False) -> str:
    """Compile the sources if the library for their hash is missing; return
    its path. ``verbose`` adds ``-Xptxas -v`` and keeps nvcc's output in
    :data:`build_log` (registers, shared memory and spills per kernel)."""
    global build_log
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    extra = ['-Xptxas', '-v'] if verbose else []
    objs = [os.path.join(work, os.path.basename(src) + '.o') for src in _sources()]
    jobs = []
    try:
        for src, obj in zip(_sources(), objs):
            cmd = [_nvcc()] + ARCH_FLAGS + FLAGS + extra + ['-c', '-o', obj, src]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        failed = []
        build_log = ''
        while jobs:
            cmd, proc = jobs.pop(0)
            out, _ = proc.communicate()
            build_log += out
            if proc.returncode != 0:
                failed.append(f'nvcc failed ({proc.returncode}):\n{" ".join(cmd)}\n{out}')
        if failed:
            raise RuntimeError('\n'.join(failed))
        cmd = [_nvcc()] + ARCH_FLAGS + ['-shared', '-o', tmp] + objs
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({proc.returncode}):\n{" ".join(cmd)}\n{build_log}')
        os.replace(tmp, so)
    finally:
        for _, proc in jobs:          # an exception leaves none running
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            trace.count('rebuild.nvcc')
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.mdt_error_string.argtypes = [ctypes.c_int]
            handle.mdt_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


_triton_watched = False


def watch_triton_compiles() -> None:
    """Count every specialization that Triton compiles from now on as
    ``rebuild.triton``, from Triton's post-compile hook
    (``triton.knobs.runtime.jit_post_compile_hook``, Triton 3.4 and later;
    an older Triton counts nothing). A hook set before is kept and called
    after. Called where the Triton kernels are first made, so a launch
    costs nothing more."""
    global _triton_watched
    with _lock:
        if _triton_watched:
            return
        _triton_watched = True
        import triton
        rt = getattr(getattr(triton, 'knobs', None), 'runtime', None)
        if rt is None or not hasattr(rt, 'jit_post_compile_hook'):
            return
        prev = rt.jit_post_compile_hook

        def hook(*args, **kwargs):
            trace.count('rebuild.triton')
            return prev(*args, **kwargs) if prev is not None else None
        rt.jit_post_compile_hook = hook


H100_SMS = 132     # streaming multiprocessors of an H100 SXM: the plans' default


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: what the kernels'
    launch plans size their grids by."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib().mdt_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err}: {msg}')


KERNEL_WRAPPERS = []      # every wrapper kernel_wrapper declared, in the order imported
_plain = 0                # open plain() scopes


@contextlib.contextmanager
def plain():
    """Within it, every kernel wrapper runs its plain version, whatever the
    device. Process-wide, not thread-local: autograd's backward runs on
    threads of its own and reruns the checkpointed blocks there."""
    global _plain
    _plain += 1
    try:
        yield
    finally:
        _plain -= 1


def use_kernel(what: str, *tensors) -> bool:
    """Route a wrapper call by device: False within :func:`plain` or when
    every tensor lies on the CPU (the plain version), True when every
    tensor lies on a CUDA device (the kernel). Anything else raises."""
    if _plain:
        return False
    kinds = {t.device.type for t in tensors}
    if kinds == {'cpu'}:
        return False
    if kinds == {'cuda'}:
        return True
    raise RuntimeError(f'{what}: tensors on {sorted(kinds)}; expected all on the CPU '
                       f'(plain version) or all on one CUDA device (kernel)')


class PlainBackward(torch.autograd.Function):
    """The kernel forward, the plain version's gradients (the JAX package's
    ``custom_vjp`` of the conv, ``meshdiffusion_tpu/ops/gn_silu_conv.py``):
    ``apply(forward, reference, *args)`` returns ``forward(*args)``, and
    the backward recomputes ``reference(*args)`` from the saved inputs and
    differentiates it, so the GroupNorm statistics' gradients are exact.
    Only the gradients asked for are computed: the likelihood's divergence
    needs x's alone, and then no weight gradient is."""

    @staticmethod
    def forward(ctx, forward, reference, *args):
        ctx.reference = reference
        ctx.tensor_at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        ctx.others = [None if isinstance(a, torch.Tensor) else a for a in args]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        return forward(*args)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[2:]
        args = list(ctx.others)
        for i, t in zip(ctx.tensor_at, ctx.saved_tensors):
            args[i] = t.detach().requires_grad_(need[i])
        with torch.enable_grad():
            y = ctx.reference(*args)
        wrt = [args[i] for i in ctx.tensor_at if need[i]]
        grads = iter(torch.autograd.grad(y, wrt, g, allow_unused=True))
        return (None, None, *(next(grads) if n else None for n in need))


def kernel_wrapper(reference, backward=None):
    """Declare the decorated function, a kernel's launch on CUDA tensors, a
    kernel wrapper that follows the route rule (module docstring):
    ``reference`` is its plain version, with the same parameters;
    ``backward`` an autograd Function whose ``apply(forward, reference,
    *args)`` gives the call's value and its gradients, ``forward`` the call
    routed by device (:class:`PlainBackward`, or an exact backward of the
    wrapper's own), or None: under autograd the plain version. A call routes
    by the arguments of the parameters annotated as tensors (None left
    out). The wrapper is an ``ops.<name>`` span, starts with ``.launches``
    at 0 (the kernel's body counts its launches) and joins
    :data:`KERNEL_WRAPPERS`."""
    def declare(kernel):
        name, span = kernel.__name__, 'ops.' + kernel.__name__
        sig = inspect.signature(kernel)
        params = list(sig.parameters)
        if list(inspect.signature(reference).parameters) != params:
            raise TypeError(f'{name}: its plain version takes other parameters')
        tensors = [n for n, p in sig.parameters.items() if 'Tensor' in str(p.annotation)]
        lead = 0                  # the leading parameters that are tensors
        while lead < len(tensors) and params[lead] == tensors[lead]:
            lead += 1
        later = [(params.index(n), n) for n in tensors[lead:]]

        def bound(args, kwargs):
            b = sig.bind(*args, **kwargs)
            b.apply_defaults()
            return b

        # bound once: every wrapper call reads them
        recording, is_grad_enabled = trace._enabled, torch.is_grad_enabled

        @functools.wraps(kernel)
        def wrapper(*args, **kwargs):
            rec = trace._open(span, None) if recording() else None
            try:
                if len(args) >= lead:
                    ts = args[:lead]
                    for i, n in later:
                        t = args[i] if i < len(args) else kwargs.get(n)
                        if t is not None:
                            ts += (t,)
                else:             # a leading tensor given by keyword
                    a = bound(args, kwargs).arguments
                    ts = tuple(a[n] for n in tensors if a[n] is not None)
                if is_grad_enabled() and any(t.requires_grad for t in ts):
                    if backward is None:
                        return reference(*args, **kwargs)
                    forward = kernel if use_kernel(name, *ts) else reference
                    return backward.apply(forward, reference, *bound(args, kwargs).args)
                if use_kernel(name, *ts):
                    return kernel(*args, **kwargs)
                return reference(*args, **kwargs)
            finally:
                if rec is not None:
                    trace._close(rec)

        wrapper.launches = 0
        KERNEL_WRAPPERS.append(wrapper)
        return wrapper
    return declare
