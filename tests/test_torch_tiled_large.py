"""Tiles past the tiled kernels' whole-tile staging, on the CPU.

The tiled kernels (K2-K6, ``celeste_tpu_torch/csrc/tiled_field.cu``) stage
a tile's s_cap * C components whole where they fit a block's shared memory
and in chunks past that (the staged path, ``kernels/tiled_field.py``
``tile_staged``).  Here: a crowded field whose densest tile holds 891
components, built by both packages' ``crowded_field`` entry
(``experiments._crowded_problem``), its tiled log density and gradient
against JAX's (values rtol 2e-6, atol 1.0; gradients rtol 5e-4, atol 0.1:
tests/test_tiled_field.py:97, :129); the path chooser and its byte
arithmetic against the kernel source; and the chunk walk written out.  The
kernels themselves are held against the plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import copy
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celeste_tpu.experiments import CONFIGS as J_CONFIGS
from celeste_tpu.experiments import _crowded_problem as j_crowded_problem

from celeste_tpu_torch.experiments import CONFIGS, _crowded_problem
from celeste_tpu_torch.kernels import mog_field as tmf
from celeste_tpu_torch.kernels import tiled_field as ttf
from celeste_tpu_torch.kernels.tiled_field import random_tile_problem
from celeste_tpu_torch.parallel import crowded as tcrowded

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = dict(rtol=2e-6, atol=1.0)
GRAD_TOL = dict(rtol=5e-4, atol=0.1)
SOURCE = Path(ttf.__file__).resolve().parent.parent / "csrc" / "tiled_field.cu"
# the most components a tile stages whole: K2 and K3, K5, K4 and K6
WHOLE_TILE_LIMITS = {"fwd": 812, "render": 876, "bwd": 744}
LOG2E = 1.4426950408889634


def test_crowded_field_past_the_whole_tile_matches_jax(monkeypatch):
    """``crowded_field tiled=true`` with 32 sources, 24 of them galaxies, on
    64x64: the densest bucket's tiles list 297 component blocks of 3 (891
    components, past every kernel's whole-tile staging, so the card takes
    the staged path); the port's log density and gradient at 3 chains
    around the start equal JAX's."""
    built = []
    real = tcrowded.make_tiled_crowded_logdensity

    def recording(*a, **kw):
        out = real(*a, **kw)
        built.append(out[1])
        return out

    monkeypatch.setattr(tcrowded, "make_tiled_crowded_logdensity", recording)
    cfg = copy.deepcopy(CONFIGS["crowded_field"])
    jcfg = copy.deepcopy(J_CONFIGS["crowded_field"])
    for c in (cfg, jcfg):
        for k, v in dict(tiled=True, n_sources=32, n_galaxies=24, shape=(64, 64)).items():
            setattr(c, k, v)
    cfg.device = "cpu"
    _, logd, x0 = _crowded_problem(cfg, torch.device("cpu"))
    _, jlogd, jx0 = j_crowded_problem(jcfg)
    np.testing.assert_array_equal(x0, jx0)
    (data,) = built
    caps = [s_cap * 3 for _, s_cap in data.buckets]
    assert max(caps) == 891, caps
    assert all(ttf.tile_staged(k, 891) for k in WHOLE_TILE_LIMITS)

    xs = (x0[None] + 0.01 * np.random.default_rng(8).normal(size=(3, x0.size))).astype(
        np.float32)
    xt = torch.tensor(xs, requires_grad=True)
    val = logd(xt)
    (grad,) = torch.autograd.grad(val.sum(), xt)
    jval, jgrad = jax.jit(jax.vmap(jax.value_and_grad(jlogd)))(jnp.asarray(xs))
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), **GRAD_TOL)


@pytest.mark.parametrize("kernel", sorted(WHOLE_TILE_LIMITS))
def test_tile_staged_only_past_the_whole_tile_staging(kernel):
    """Config 5's tiles (99 and 114 components) and every tile up to the
    kernel's limit keep the whole-tile path; every tile past it, the crowded
    fields' 891 and 1218 and a random problem's 2400 among them, takes the
    staged path."""
    limit = WHOLE_TILE_LIMITS[kernel]
    assert not ttf.tile_staged(kernel, 99) and not ttf.tile_staged(kernel, 114)
    assert not any(ttf.tile_staged(kernel, n) for n in range(1, limit + 1))
    assert ttf.tile_smem_bytes(kernel, limit) <= ttf.SMEM_OPTIN
    assert all(ttf.tile_staged(kernel, n) for n in range(limit + 1, 2500))
    assert all(ttf.tile_staged(kernel, n) for n in (891, 1218, 2400))


def _c_constant(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


def _c_function(source, name):
    """The returned expression of a one-statement C function of the source,
    as Python: casts dropped, sizeof(float) 4, sizeof(float4) 16."""
    body = re.search(rf"size_t {name}\([^)]*\) \{{\s*return (.*?);\s*\}}", source, re.S).group(1)
    body = " ".join(re.sub(r"static_cast<size_t>", "", body).split())
    return body.replace("sizeof(float4)", "16").replace("sizeof(float)", "4")


def test_tile_smem_bytes_is_the_kernels_arithmetic():
    """``tile_smem_bytes`` evaluates the source's ``fwd_smem_bytes`` and
    ``bwd_smem_bytes`` with the source's constants; the staged path's chunk
    leaves two blocks an SM (228 KB, 1 KB of it reserved per block)."""
    src = SOURCE.read_text()
    consts = {name: _c_constant(src, name)
              for name in ("kPix", "kWarps", "kBwdEntries", "kTileChunk")}
    assert consts == {"kPix": ttf.PIX_PER_TILE, "kWarps": ttf.TILE_WARPS,
                      "kBwdEntries": ttf.BWD_ENTRIES, "kTileChunk": ttf.TILE_CHUNK}
    assert ttf.SMEM_OPTIN == tmf.SMEM_OPTIN
    fwd, bwd = _c_function(src, "fwd_smem_bytes"), _c_function(src, "bwd_smem_bytes")

    def env(n_w, arrays=6):
        return dict(consts, n_w=n_w, n_pixel_arrays=arrays,
                    round_up=lambda n, m: (n + m - 1) // m * m)

    for n in (1, 7, 8, 99, 114, 256, 744, 745, 812, 813, 876, 877, 891, 1218, 2400):
        assert ttf.tile_smem_bytes("fwd", n) == eval(fwd, env(n, 6))
        assert ttf.tile_smem_bytes("render", n) == eval(fwd, env(n, 2))
        assert ttf.tile_smem_bytes("bwd", n) == eval(bwd, env(n))
    for kernel in WHOLE_TILE_LIMITS:
        assert 2 * (ttf.tile_smem_bytes(kernel, ttf.TILE_CHUNK) + 1024) <= 228 * 1024


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("n_k", [1, 7, 114, 255, 256, 257, 744, 745, 891, 1218, 2400])
def test_chunk_walk_covers_every_entry_once_in_order(kernel, n_k):
    """Both paths' walks stage entries 0 .. n_k - 1 once each, in index
    order (the backward's padded to a whole pass of BWD_ENTRIES with zero
    entries), the staged one TILE_CHUNK at a time, every backward chunk a
    multiple of BWD_ENTRIES."""
    pad = ttf.BWD_ENTRIES if kernel == "bwd" else 1
    for staged in (False, True):
        walk = ttf.tile_chunk_walk(kernel, n_k, staged)
        entries = [k0 + i for k0, n in walk for i in range(n)]
        assert entries == list(range(-(-n_k // pad) * pad))
        assert all(n % pad == 0 for _, n in walk)
        if staged:
            assert all(n <= ttf.TILE_CHUNK for _, n in walk)
            assert [k0 for k0, _ in walk] == list(range(0, n_k, ttf.TILE_CHUNK))
        else:
            assert len(walk) == 1


def test_chunked_walk_gives_the_whole_tile_bits(monkeypatch):
    """Each pixel's lambda from sky plus a_k 2^(form) over k in the order of
    the staged walk (chunks of 16 here) is bitwise the whole walk's; so is
    each entry's moment sum over the pixels, which depends on that entry
    alone."""
    monkeypatch.setattr(ttf, "TILE_CHUNK", 16)
    planes, tile_src, pixels, g = random_tile_problem(seed=4, b=3, s=20, c=3, t=2)
    amp, mx, my, pa, pb, pc = (torch.as_tensor(p) for p in planes)
    px, py, _, sky, _ = (torch.as_tensor(p) for p in pixels)
    cols = ttf._tile_cols(torch.as_tensor(tile_src), 3)
    n_k = cols.shape[1]

    def walk(t, staged):
        lam = sky[t].expand(3, -1).clone()
        moments = []
        for k0, n in ttf.tile_chunk_walk("fwd", n_k, staged):
            for k in range(k0, k0 + n):
                c = cols[t, k]
                dx, dy = px[t] - mx[:, c, None], py[t] - my[:, c, None]
                form = ((-0.5 * LOG2E * pa[:, c, None]) * dx + (-LOG2E * pb[:, c, None]) * dy) * dx
                e = torch.exp2(form + (-0.5 * LOG2E * pc[:, c, None]) * dy * dy)
                lam = lam + amp[:, c, None] * e
                moments.append((e * dx).sum(-1))
        return lam, torch.stack(moments)

    assert len(ttf.tile_chunk_walk("fwd", n_k, True)) == 4
    for t in range(2):
        whole, staged = walk(t, False), walk(t, True)
        assert torch.equal(whole[0], staged[0]) and torch.equal(whole[1], staged[1])
