"""The work count: it repeats exactly, it matches a hand count, and it
does not depend on the program's tiling."""

import numpy as np
import pytest

from skybench import catalog
from skybench.reference.field import Field, make_field
from skybench.work import gradient_work, live_components, needed_terms


def _field(name, seed=3, **posterior):
    cfg = catalog.load_json("configs", name)
    cfg["posterior"] = dict(cfg["posterior"], **posterior)
    return cfg, make_field(cfg, np.random.default_rng(seed))


def test_counts_repeat_exactly():
    _, a = _field("c5_r", seed=1)
    _, b = _field("c5_r", seed=2)
    assert needed_terms(a) == needed_terms(b) == needed_terms(a)
    assert gradient_work(a, 32768) == gradient_work(b, 32768)
    _, g = _field("c5_gri")
    assert needed_terms(g) == needed_terms(a) * 3


def test_two_source_toy_scene_by_hand():
    """An 11x11 field, a three-component PSF: a star at (5, 5) with radius
    1 covers its pixel and four neighbours (5 pixels); a galaxy in the
    corner (0, 0) with blocks of radius 1.5 (its pixel, (1, 0), (0, 1),
    (1, 1): 4) and 0.5 (1), the rest dropped: (5 + 4 + 1) x 3 = 30 terms;
    live components (1 + 2) x 3 = 9."""
    radii = np.full((2, 16), -1.0)
    radii[0, 0], radii[1, 0], radii[1, 1] = 1.0, 1.5, 0.5
    one = np.ones((1, 11, 11))
    f = Field(kinds=("star", "galaxy"), bands=(2,), pos_px=np.array([[5.0, 5.0], [0.0, 0.0]]),
              counts=one, sky=np.ones(1), iota=np.ones(1), mask=one,
              psf_w=np.ones((1, 3)) / 3, psf_var=np.ones((1, 3)), jac=np.eye(2),
              p0=np.zeros(2), truth=np.zeros(11), radii=radii)
    assert needed_terms(f) == [30]
    assert live_components(f) == 9
    w = gradient_work(f, 2)
    assert w.flops == 2 * 30 * (9 + 2 + 9 + 12) + 2 * 121 * 10 + 2 * 9 * 12
    assert w.special == 2 * 2 * 30 + 2 * 121
    assert w.nbytes == (12 * 2 * 9 + 5 * 121 + 4) * 4


@pytest.mark.parametrize("n_buckets", [1, 3])
def test_count_does_not_follow_the_tiling(n_buckets, monkeypatch):
    """Other bucket counts and another tile height leave the count as it is;
    it is below the program's tile-table entries x pixels a tile."""
    from celeste_tpu_torch.kernels.tiled_field import TiledStampData
    from celeste_tpu_torch.parallel import tiles
    from skybench.scene import port_logdensity

    cfg, base = _field("c5_r")
    _, other = _field("c5_r", n_buckets=n_buckets)
    assert gradient_work(other, 1024) == gradient_work(base, 1024)
    counted = []
    for tile_h in (8, 4):
        monkeypatch.setattr(tiles, "TILE_H", tile_h)
        monkeypatch.setattr(tiles, "PIX_PER_TILE", tile_h * 128)
        _, datas, _ = port_logdensity(other, cfg, "cpu")
        d: TiledStampData = datas[0]
        entries = int((d.tile_src < d.tile_map.n_sources).sum()) * 3
        counted.append((entries * tile_h * 128, gradient_work(other, 1024)))
    assert counted[0][1] == counted[1][1] == gradient_work(base, 1024)
    assert needed_terms(base)[0] < min(c[0] for c in counted)
