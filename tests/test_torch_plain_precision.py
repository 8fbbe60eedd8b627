"""The plain versions keep their fp32 arithmetic whatever the process sets.

The plain versions are the port's CPU path and the yardstick of every
kernel, and a few process-wide settings lower the precision of a float32
matrix product on the CPU: on a CPU with bf16 units (AVX512-BF16, AMX)
``torch.set_float32_matmul_precision("medium")`` or oneDNN's
``fp32_precision = "bf16"`` runs it in bf16.  The
plain versions pin IEEE fp32 for their own products (``ops/plain.py``).
Each test puts the process into one such state and holds the plain
versions to the JAX package there, at the tolerances of their own parity
tests:

* the linear attention against ``blockdiag_linear_attention`` (fp32, 1e-5
  of the largest output, ``test_torch_linear_attention.py``), at the case
  that once drifted to 1.9e-5 in a test worker and at a prenorm case;
* the window attention, forward and backward, against
  ``fused_window_attention`` and its ``jax.vjp`` (the Pallas kernels in
  interpret mode; 1e-5 absolute);
* the whole Swin block, forward and backward, against ``fused_swin_block``
  and its ``jax.vjp`` (interpret mode; y 1e-5 absolute, dx 1e-4 absolute,
  each parameter gradient 1e-5 of max(1, its largest value)).

The states: the legacy and the oneDNN precision settings at bf16 and tf32,
the process-wide ``torch.backends.fp32_precision``, the caller's CPU
autocast to bf16, one intra-op thread, and denormals flushed to zero.  Each
is undone after its test.  The JAX side is computed once per module.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from dmhomo_torch.ops import linear_attention as la
from dmhomo_torch.ops import swin_block as sb
from dmhomo_torch.ops import window_attention as wa

from test_torch_linear_attention import TOL as LA_TOL
from test_torch_linear_attention import _inputs as la_inputs
from test_torch_linear_attention import _rel_err as la_rel_err
from test_torch_swin_block import KERNELS, _port_params
from test_torch_swin_block import _inputs as sb_inputs
from test_torch_swin_block import _rel_err as sb_rel_err
from test_torch_swin_block_bwd import DX_TOL
from test_torch_window_attention_bwd import _inputs as wa_inputs

# the process-wide precision settings, new API, saved and restored around each state
SETTINGS = [("fp32_precision",), ("mkldnn", "fp32_precision"), ("mkldnn", "matmul", "fp32_precision"),
            ("mkldnn", "conv", "fp32_precision"), ("mkldnn", "rnn", "fp32_precision"),
            ("cuda", "matmul", "fp32_precision"), ("cudnn", "fp32_precision"),
            ("cudnn", "conv", "fp32_precision"), ("cudnn", "rnn", "fp32_precision")]


def _getting(path):
    obj = torch.backends
    for name in path[:-1]:
        obj = getattr(obj, name)
    return obj, path[-1]


def _settings():
    return [getattr(*_getting(p)) for p in SETTINGS]


def _set(path, value):
    setattr(*_getting(path), value)


@contextlib.contextmanager
def _legacy(precision):
    torch.set_float32_matmul_precision(precision)
    yield


@contextlib.contextmanager
def _setting(path, value):
    _set(path, value)
    yield


@contextlib.contextmanager
def _threads(n):
    torch.set_num_threads(n)
    yield


@contextlib.contextmanager
def _flush_denormal():
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


STATES = {
    "matmul_precision_medium": lambda: _legacy("medium"),
    "matmul_precision_high": lambda: _legacy("high"),
    "mkldnn_matmul_bf16": lambda: _setting(("mkldnn", "matmul", "fp32_precision"), "bf16"),
    "mkldnn_matmul_tf32": lambda: _setting(("mkldnn", "matmul", "fp32_precision"), "tf32"),
    "mkldnn_bf16": lambda: _setting(("mkldnn", "fp32_precision"), "bf16"),
    "backends_bf16": lambda: _setting(("fp32_precision",), "bf16"),
    "autocast_cpu_bf16": lambda: torch.autocast("cpu", dtype=torch.bfloat16),
    "one_thread": lambda: _threads(1),
    "flush_denormal": _flush_denormal,
}


@pytest.fixture(params=sorted(STATES))
def state(request):
    """The process in one candidate state for the test, as it was after it."""
    saved, threads = _settings(), torch.get_num_threads()
    try:
        with STATES[request.param]():
            yield request.param
    finally:
        torch.set_float32_matmul_precision("highest")
        for path, value in zip(SETTINGS, saved):
            _set(path, value)
        torch.set_num_threads(threads)
    assert _settings() == saved and torch.get_float32_matmul_precision() == "highest"


LA_CASES = [(24, 64, False), (64, 200, True)]  # (C, N, prenorm): the drifted case first


@functools.lru_cache(maxsize=None)
def _la_case(C, N, prenorm):
    import jax
    import jax.numpy as jnp

    from dmhomo_tpu.ops.linear_attention import blockdiag_linear_attention

    x, w, g = la_inputs(np.random.default_rng(N), 2, N, C)
    pn = None
    if prenorm:
        xf = jnp.asarray(x)
        pn = (xf.mean(-1, keepdims=True), jax.lax.rsqrt(xf.var(-1, keepdims=True) + 1e-5),
              jnp.asarray(g))
    want = np.asarray(blockdiag_linear_attention(jnp.asarray(x), jnp.asarray(w), prenorm=pn))
    return x, w, g, want


@pytest.mark.parametrize("C, N, prenorm", LA_CASES)
def test_linear_attention_matches_blockdiag(state, C, N, prenorm):
    x, w, g, want = _la_case(C, N, prenorm)
    got = la.linear_attention(torch.from_numpy(x), torch.from_numpy(w),
                              prenorm=(torch.from_numpy(g),) if prenorm else None)
    assert got.dtype == torch.float32
    assert la_rel_err(got.numpy(), want) <= LA_TOL["float32"]


@functools.lru_cache(maxsize=None)
def _wa_case():
    import jax
    import jax.numpy as jnp

    from dmhomo_tpu.ops.window_attention import fused_window_attention

    C, h = 24, 3
    qkv, bias, mask, gout = wa_inputs(np.random.default_rng(7), 8, 4, C, h, True)
    jmask = jnp.asarray(mask)

    def f(q, b):
        return fused_window_attention(q, b, jmask, num_heads=h, scale=(C // h)**-0.5,
                                      interpret=True)

    out, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(bias))
    return (qkv, bias, mask, gout, h,
            (np.asarray(out), *(np.asarray(t) for t in vjp(jnp.asarray(gout)))))


def test_window_attention_matches_pallas(state):
    qkv, bias, mask, gout, h, want = _wa_case()
    args = [torch.from_numpy(a) for a in (qkv, bias, mask)]
    out = wa.window_attention(*args, num_heads=h)
    dqkv, dbias = wa.window_attention_backward_reference(*args, torch.from_numpy(gout),
                                                         num_heads=h)
    for got, w in zip((out, dqkv, dbias), want):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5, rtol=0)


@functools.lru_cache(maxsize=None)
def _sb_case():
    import jax
    import jax.numpy as jnp

    from dmhomo_tpu.ops.swin_block import fused_swin_block

    B, H, W, C, heads, hidden, shift = 1, 8, 16, 24, 3, 48, 4
    x, params, mask = sb_inputs(11, B, H, W, C, heads, hidden, shift)
    dy = np.random.default_rng(12).normal(0, 1, x.shape).astype(np.float32)

    def f(xx, pp):
        return fused_swin_block(xx, pp, jnp.asarray(mask), resolution=(H, W), window_size=8,
                                num_heads=heads, shift=shift)

    y, vjp = jax.vjp(f, jnp.asarray(x).reshape(B, H * W, C), tuple(jnp.asarray(p) for p in params))
    dx, grads = vjp(jnp.asarray(dy).reshape(B, H * W, C))
    grads = [np.array(np.asarray(g).T if n in KERNELS else g)
             for n, g in zip(sb.PARAM_NAMES, grads)]
    return (x, params, mask, dy, heads, shift, np.asarray(y).reshape(x.shape),
            np.asarray(dx).reshape(x.shape), grads)


def test_swin_block_matches_pallas(state):
    x, params, mask, dy, heads, shift, want_y, want_dx, want_grads = _sb_case()
    args = (torch.from_numpy(x), _port_params(params), torch.from_numpy(mask))
    y = sb.swin_block_reference(*args, num_heads=heads, shift=shift)
    dx, grads = sb.swin_block_backward_reference(*args, torch.from_numpy(dy), num_heads=heads,
                                                 shift=shift)
    assert y.dtype == dx.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want_y, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=DX_TOL, rtol=0)
    for name, got, w in zip(sb.PARAM_NAMES, grads, want_grads):
        assert sb_rel_err(got, torch.from_numpy(w)) <= 1e-5, name


def test_exact_restores_the_process_settings():
    """``exact`` leaves the settings as it found them, a legacy setting too."""
    from dmhomo_torch.ops.plain import exact

    saved = _settings()
    try:
        torch.set_float32_matmul_precision("medium")
        before = _settings()
        with exact("cpu"):
            assert torch.backends.mkldnn.matmul.fp32_precision == "ieee"
            assert torch.backends.cuda.matmul.fp32_precision == "ieee"
            assert not torch.is_autocast_enabled("cpu")
        assert _settings() == before and torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision("highest")
        for path, value in zip(SETTINGS, saved):
            _set(path, value)
