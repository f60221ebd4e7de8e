"""The kernels' wrappers and plain versions against the Pallas kernels.

On the CPU each wrapper computes its kernel's function with the plain
version, so these tests hold the function every CUDA kernel must compute
(minima with first argmins, the self-similarity t vectors, the backward
product (G + G^T) x^) against the JAX kernels run in interpret mode.
The CUDA kernels themselves run only on a card: their tests are in
``test_torch_cuda.py``, marked ``cuda``, and skip without a card;
``chip_smoke.py`` holds them against the plain versions on the card at
the main path's shapes.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strotss_torch.ops.kernels import build, remd, selfsim
from strotss_torch.ops.kernels.common import resolve_impl
from strotss_torch.utils import timing
from strotss_tpu.ops.kernels import selfsim as jselfsim
from strotss_tpu.ops.kernels.remd import _mins_pallas_call, relaxed_emd_pallas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _grad_close(g, ref, frac=1e-4):
    g, ref = np.asarray(g), np.asarray(ref)
    assert np.abs(g - ref).max() <= frac * np.abs(ref).max()


def _project(u, h):
    return (u - torch.sum(u * h, dim=1, keepdim=True) * h).numpy()


@pytest.mark.parametrize("n,m,c,dist", [
    (100, 130, 35, "cosine"), (64, 48, 3, "both"), (70, 90, 11, "l2"),
    (200, 150, 64, "both"),
])
def test_mins_argmins_equal_pallas(n, m, c, dist):
    """Continuous inputs: the plain K1's first argmins equal the Pallas
    kernel's exactly, and the minima agree to rtol 1e-5."""
    x, y = _rand(n, (n, c)), _rand(m + 1, (m, c))
    jr, jc, jra, jca = _mins_pallas_call(jnp.asarray(x), jnp.asarray(y),
                                         dist, True)
    tr, tc, tra, tca = remd.mins(torch.tensor(x), torch.tensor(y), dist)
    np.testing.assert_array_equal(tra.numpy(), np.asarray(jra))
    np.testing.assert_array_equal(tca.numpy(), np.asarray(jca))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)


@pytest.mark.parametrize("dist", ["cosine", "l2", "both"])
def test_remd_vjp_matches_pallas(dist):
    """The argmin-pair VJP (the port of ``_mins_bwd``) that the kernel path
    uses, run here on the plain minima."""
    x, y = _rand(1, (48, 13)), _rand(2, (56, 13))
    jg = jax.grad(lambda a, b: relaxed_emd_pallas(a, b, dist),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    r, c = remd.RemdMins.apply(xt, yt, dist)
    tg = torch.autograd.grad(torch.maximum(r.mean(), c.mean()), [xt, yt])
    for a, b in zip(tg, jg):
        _grad_close(a.numpy(), b)


@pytest.mark.parametrize("n,c", [(96, 20), (130, 35)])
def test_selfsim_pieces_match_pallas(n, c):
    """selfsim_fwd's (loss, t_x, t_y, signs) and selfsim_bwd's (G + G^T) x^
    on those signs against the Pallas forward and its two backward sweeps,
    which recompute the signs from D."""
    x, y = _rand(n, (n, c)), _rand(n + 1, (n, c))
    jloss, res, _ = jselfsim._fwd_impl(jnp.asarray(x), jnp.asarray(y), True)
    xh, yh, _, _, xp, yp, cxp, cyp, jtx, jty, n_, np_, cp, tn = res
    u = jselfsim._bwd_call(xp, yp, cxp, cyp, jtx, jty, n_, np_, cp, tn,
                           False, True)
    v = jselfsim._bwd_call(xp, yp, cxp, cyp, jtx, jty, n_, np_, cp, tn,
                           True, True)
    txh, tyh, _, _, tcx, tcy = selfsim._prep(torch.tensor(x), torch.tensor(y))
    loss, tx, ty, signs = selfsim.selfsim_fwd(txh, tyh, tcx, tcy)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for t, j in ((tx, jtx), (ty, jty)):
        j = np.asarray(j)[0, :n]
        assert np.abs(t.numpy() - j).max() <= 1e-5 * np.abs(j).max()
    ux, uy = selfsim.selfsim_bwd(txh, tyh, tcx, tcy, tx, ty, signs)
    for got, i, h in ((ux, 0, txh), (uy, 1, tyh)):
        want = torch.tensor(np.asarray(u[i] + v[i])[:n, :c])
        # compared after the pull-back's projection off x^_i: the diagonal
        # term G_ii x^_i has the sign of a difference that is 0 up to
        # rounding, and the projection removes exactly that term
        _grad_close(_project(got, h), _project(want, h))


def test_selfsim_function_grads_match_pallas():
    x, y = _rand(3, (96, 20)), _rand(4, (96, 20))
    jg = jax.grad(lambda a, b: jselfsim.self_similarity_pallas(a, b, True),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    tg = torch.autograd.grad(selfsim.SelfSimilarity.apply(xt, yt), [xt, yt])
    for a, b in zip(tg, jg):
        _grad_close(a.numpy(), b)


def test_cpu_tensors_take_the_plain_version():
    x, y = torch.tensor(_rand(5, (40, 9))), torch.tensor(_rand(6, (30, 9)))
    before = timing.counters()
    for got, want in zip(remd.mins(x, y, "cosine"),
                         remd.mins_plain(x, y, "cosine")):
        assert torch.equal(got, want)
    xs = torch.tensor(_rand(7, (40, 9)))
    xh, yh, _, _, cx, cy = selfsim._prep(x, xs)
    loss, tx, ty, signs = selfsim.selfsim_fwd(xh, yh, cx, cy)
    assert torch.equal(loss, selfsim.selfsim_fwd_plain(xh, yh, cx, cy)[0])
    selfsim.selfsim_bwd(xh, yh, cx, cy, tx, ty, signs)
    # nothing was launched
    assert timing.counters() == before
    assert resolve_impl("auto", x) == "plain"


def test_kernel_impl_on_cpu_raises():
    x = torch.tensor(_rand(8, (16, 5)))
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        remd.remd_mins(x, x, "cosine", impl="kernel")
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        selfsim.self_similarity(x, x, impl="kernel")
    with pytest.raises(ValueError, match="impl must be"):
        remd.remd_mins(x, x, "cosine", impl="xla")


def test_imports_without_nvcc(tmp_path):
    """The kernel modules import, and the builder fails with a clear error
    only when a kernel is asked for, where there is no nvcc."""
    code = (
        "import strotss_torch.ops.kernels.remd, strotss_torch.ops.kernels."
        "selfsim as s\n"
        "from strotss_torch.ops.kernels import build\n"
        "build.NVCC_DEFAULT = '/nonexistent/nvcc'\n"
        "try:\n    build._nvcc()\nexcept RuntimeError as e:\n"
        "    print('raised', 'nvcc not found' in str(e))\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised True"


def test_build_sources_and_signatures():
    """Every C entry point the wrappers call names a source that exists."""
    for name, (lib, argtypes) in build._SIGNATURES.items():
        src = os.path.join(build.CSRC, f"{lib}.cu")
        with open(src) as f:
            assert f'extern "C" int {name}(' in f.read()
        assert argtypes[-1] is build._P  # the stream comes last
