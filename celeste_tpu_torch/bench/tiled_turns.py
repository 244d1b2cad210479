"""The tiled field kernels K2-K6 (``csrc/tiled_field.cu``) against an
earlier version of their source, built and timed in turns in one process
on one card; and the tile problems past the whole-tile staging that
``chip_smoke.py`` and the card tests share (:func:`crowded_tiles`,
:func:`random_tiles`).

    python -m celeste_tpu_torch.bench.tiled_turns --parent DIR
        [--parent-staged-flag] [--out FILE]

``DIR`` holds the earlier ``tiled_field.cu`` and ``mog_common.cuh`` (for
example ``git show <rev>:celeste_tpu_torch/csrc/tiled_field.cu``).  The
parent's entries take no ``staged`` argument (the sources before the
staged path) unless ``--parent-staged-flag`` says they take this tree's (a
variant of it).  The script

1. builds both sources with the package's nvcc flags plus ``-Xptxas -v``,
   prints each kernel's registers and spills, and says whether each of the
   parent's kernels has the same SASS (``cuobjdump -sass``, addresses left
   out) as this tree's whole-tile instantiation of it;
2. runs K2, K3, K4, K5 and K6 of both over config 5's two occupancy
   buckets (114 and 99 components a tile) at B = 1024 and 4096, on
   config-5 planes scattered around the truth (K4 from one K3 lambda, K5
   and K6 on the same buckets' pixels with a random cotangent), and holds
   the new outputs against the parent's: max abs difference, 0 when the
   bits are kept;
3. times each kernel of both in turns (parent, new, new, parent), each turn
   the best of 3 replays of a CUDA graph of 20 calls of both buckets
   (``bench/timing.py``), in ms per bucket call;
4. runs and times this tree's staged path forced on the same buckets,
   bitwise against its whole-tile path, so the two paths' times compare on
   one shape.

``--out`` takes a JSON of the numbers and the SASS listings.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from celeste_tpu_torch.kernels import tiled_field as tf
from celeste_tpu_torch.parallel.tiles import PIX_PER_TILE

KERNELS = ("K2", "K3", "K4", "K5", "K6")
TURN_CHAINS = (1024, 4096)


# ---------------------------------------------------------------------------
# tile problems past the whole-tile staging
# ---------------------------------------------------------------------------

def crowded_tiles(n_sources, n_galaxies, shape, b, device, seed=0):
    """``crowded_field tiled=true`` with ``n_sources`` sources, the first
    ``n_galaxies`` of them galaxies, on a ``shape`` field, as
    ``experiments._crowded_problem`` builds it: (its occupancy buckets'
    ``TileBucket`` list, six block planes [b, (S N_GAL + 1) K] of ``b``
    chains around the start, x0 + 0.01 N(0, 1) from ``seed``, the sentinel
    slot S N_GAL, the component count K)."""
    from celeste_tpu_torch.experiments import CONFIGS, _crowded_problem
    from celeste_tpu_torch.model.galaxy import N_GAL
    from celeste_tpu_torch.parallel import crowded

    cfg = copy.deepcopy(CONFIGS["crowded_field"])
    cfg.tiled, cfg.n_sources, cfg.n_galaxies, cfg.shape = True, n_sources, n_galaxies, shape
    built = []
    real = crowded.make_tiled_crowded_logdensity

    def recording(scene, stamp, *args, **kwargs):
        out = real(scene, stamp, *args, **kwargs)
        built.append((scene, stamp, out[1]))
        return out

    crowded.make_tiled_crowded_logdensity = recording
    try:
        _, _, x0 = _crowded_problem(cfg, torch.device(device))
    finally:
        crowded.make_tiled_crowded_logdensity = real
    ((scene, stamp, data),) = built
    rng = np.random.default_rng(seed)
    vecs = torch.as_tensor((x0[None] + 0.01 * rng.normal(size=(b, x0.size))).astype(np.float32),
                           device=device)
    planes = [p.contiguous() for p in tf.scene_planes_blocked(scene, vecs, stamp, 0)]
    return data.bucket_tables, planes, scene.n_sources * N_GAL, stamp.psf.n_components


def random_tiles(s, c, b, device, seed=0, t=3):
    """``tiled_field.random_tile_problem`` with ``s`` slots of ``c``
    components over ``t`` tiles (s c components a tile), on ``device``:
    ([its one TileBucket], six planes [b, (s + 1) c], the sentinel slot s,
    c)."""
    planes, tile_src, pixels, _ = tf.random_tile_problem(seed=seed, b=b, s=s, c=c, t=t)
    bucket = tf.TileBucket(s, torch.as_tensor(tile_src, device=device),
                           tuple(torch.as_tensor(p, device=device) for p in pixels))
    return [bucket], [torch.as_tensor(p, device=device) for p in planes], s, c


# ---------------------------------------------------------------------------
# the two builds
# ---------------------------------------------------------------------------

def build(src: Path, out: Path) -> str:
    """nvcc the source ``src`` into ``out``; returns ptxas's report."""
    from celeste_tpu_torch.kernels import _build

    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {src}:\n{proc.stdout}{proc.stderr}")
    return proc.stderr


def kernel_name(mangled: str) -> str:
    """``tiled_fwd_kernel<1, 2, 0>`` from a mangled entry name."""
    m = re.search(r"(tiled_(?:fwd|bwd|scatter)_kernel)(?:I((?:L[ib]\d+E)+)E)?", mangled)
    args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def registers(report: str) -> dict:
    """{kernel: {registers, spill_bytes}} from ptxas's report."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if name and m:
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def sass(lib: Path, listing: Path) -> dict:
    """{kernel: [instructions, addresses and encodings left out]} from
    ``cuobjdump -sass``; the listing is written to ``listing``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    listing.write_text(text)
    out = {}
    for block in text.split("Function : ")[1:]:
        name = kernel_name(block.split("\n", 1)[0].strip())
        out[name] = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", block)
    return out


def whole_tile_name(name: str) -> str:
    """This tree's whole-tile instantiation of a parent kernel: the same
    template arguments and kStaged = 0 (the scatter kernel has none)."""
    if name.startswith("tiled_scatter"):
        return name
    return name[:-1] + ", 0>"


# ---------------------------------------------------------------------------
# the raw entries, over preallocated outputs
# ---------------------------------------------------------------------------

def bucket_calls(lib, planes, bucket, n_comp, g, g_render, lam_in, staged_flag, staged=None):
    """{kernel: closure} of one bucket's K2-K6 through ``lib``'s entries,
    each returning its outputs (overwritten by the next call).  K4 reads
    ``lam_in``.  ``staged_flag``: the entries take the staged argument;
    ``staged``: force that path (None: the path ``tile_staged`` picks)."""
    b, plane_w = planes[0].shape
    n_tiles, s_cap = bucket.tile_src.shape
    n_k = s_cap * n_comp
    dev = planes[0].device
    px, py, counts, sky, mask = bucket.pixels
    col_ptr, col_ent = bucket.columns(n_comp, plane_w)
    partial = torch.empty(n_tiles, b, device=dev)
    lam = torch.empty(n_tiles, b, PIX_PER_TILE, device=dev)
    d_part = torch.empty(6, n_tiles * n_k, b, device=dev)
    d_planes = torch.empty(6, b, plane_w, device=dev)
    p = [t.data_ptr() for t in planes]
    ts = bucket.tile_src.data_ptr()

    def flag(kernel):
        if not staged_flag:
            return []
        return [int(tf.tile_staged(kernel, n_k) if staged is None else staged)]

    def run(fn, *args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    def k2():
        run(lib.tiled_field_fwd, *p, ts, *(t.data_ptr() for t in bucket.pixels),
            partial.data_ptr(), None, n_tiles, b, plane_w, s_cap, n_comp, 0, *flag("fwd"))
        return (partial,)

    def k3():
        run(lib.tiled_field_fwd, *p, ts, *(t.data_ptr() for t in bucket.pixels),
            partial.data_ptr(), lam.data_ptr(), n_tiles, b, plane_w, s_cap, n_comp, 0,
            *flag("fwd"))
        return partial, lam

    def k4():
        run(lib.tiled_field_bwd, *p, ts, px.data_ptr(), py.data_ptr(), counts.data_ptr(),
            mask.data_ptr(), lam_in.data_ptr(), g.data_ptr(), col_ptr.data_ptr(),
            col_ent.data_ptr(), d_part.data_ptr(), d_planes.data_ptr(), n_tiles, b, plane_w,
            s_cap, n_comp, *flag("bwd"))
        return (d_planes,)

    def k5():
        run(lib.tiled_field_render, *p, ts, px.data_ptr(), py.data_ptr(), lam.data_ptr(),
            n_tiles, b, plane_w, s_cap, n_comp, *flag("render"))
        return (lam,)

    def k6():
        run(lib.tiled_field_render_bwd, *p, ts, px.data_ptr(), py.data_ptr(),
            g_render.data_ptr(), col_ptr.data_ptr(), col_ent.data_ptr(), d_part.data_ptr(),
            d_planes.data_ptr(), n_tiles, b, plane_w, s_cap, n_comp, *flag("bwd"))
        return (d_planes,)

    return dict(zip(KERNELS, (k2, k3, k4, k5, k6)))


def declare_parent(lib, staged_flag):
    """The parent's entries: this tree's, or without the staged argument."""
    tf._declare(lib)
    if staged_flag:
        return
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tiled_field_fwd.argtypes = [p] * 14 + [i] * 6 + [p]
    lib.tiled_field_bwd.argtypes = [p] * 17 + [i] * 5 + [p]
    lib.tiled_field_render.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.tiled_field_render_bwd.argtypes = [p] * 14 + [i] * 5 + [p]


def max_abs(got, want):
    return max(float((a - w).abs().max()) for a, w in zip(got, want))


def main() -> int:
    from celeste_tpu_torch.bench.config5 import build_config5
    from celeste_tpu_torch.bench.timing import graph_ms
    from celeste_tpu_torch.kernels import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--parent-staged-flag", action="store_true",
                    help="the parent's entries take the staged argument (a variant of this "
                         "tree); without it, they are the sources before the staged path")
    ap.add_argument("--out", type=Path,
                    default=_build.BUILD_DIR / "tiled_turns" / "tiled_turns.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tiled_turns: CUDA is not available")
    device = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    work = _build.BUILD_DIR / "tiled_turns"
    work.mkdir(parents=True, exist_ok=True)
    libs, code = {}, {}
    report = {"card": card, "registers": {}, "same_sass_as_parent": {}, "shapes": {}}
    for tag, src in (("parent", args.parent), ("new", _build.CSRC_DIR)):
        so = work / f"{tag}.so"
        report["registers"][tag] = registers(build(src / "tiled_field.cu", so))
        code[tag] = sass(so, args.out.with_name(f"sass_tiled_{tag}.txt"))
        libs[tag] = ctypes.CDLL(str(so))
    declare_parent(libs["parent"], args.parent_staged_flag)
    tf._declare(libs["new"])
    for name, instrs in code["parent"].items():
        new_name = name if args.parent_staged_flag else whole_tile_name(name)
        report["same_sass_as_parent"][new_name] = code["new"].get(new_name) == instrs
    print(f"[tiled_turns] card: {card}", flush=True)
    print(json.dumps({"registers": report["registers"],
                      "same_sass_as_parent": report["same_sass_as_parent"]}), flush=True)

    _, _, vec, info = build_config5(device=device)
    buckets = info["tiled_data"].bucket_tables
    for b in TURN_CHAINS:
        rng = np.random.default_rng(b)
        vecs = vec[None] + torch.as_tensor(0.01 * rng.normal(size=(b, vec.shape[0])),
                                           dtype=torch.float32, device=device)
        planes = [p.contiguous() for p in tf.scene_planes_blocked(info["scene"], vecs,
                                                                  info["stamp"], 0)]
        g = torch.as_tensor(rng.normal(size=b).astype(np.float32), device=device)
        calls = {"parent": [], "new": [], "staged": []}
        for bk in buckets:
            n_tiles = bk.tile_src.shape[0]
            g_render = torch.as_tensor(rng.normal(size=(n_tiles, b, PIX_PER_TILE))
                                       .astype(np.float32), device=device)
            lam_in = tf.tiled_fwd_lam_cuda(*planes, bk.tile_src, *bk.pixels, n_comp=3)[1]
            for tag, lib, flag, staged in (("parent", libs["parent"], args.parent_staged_flag,
                                            None),
                                           ("new", libs["new"], True, None),
                                           ("staged", libs["new"], True, True)):
                calls[tag].append(bucket_calls(lib, planes, bk, 3, g, g_render, lam_in, flag,
                                               staged))
        for kernel in KERNELS:
            def both(tag, kernel=kernel):
                return [out.clone() for c in calls[tag] for out in c[kernel]()]

            want, got, staged = both("parent"), both("new"), both("staged")
            torch.cuda.synchronize()
            fns = {tag: (lambda tag=tag, kernel=kernel: [c[kernel]() for c in calls[tag]])
                   for tag in calls}
            times = {"parent": [], "new": []}
            for tag in ("parent", "new", "new", "parent"):
                times[tag].append(graph_ms(fns[tag]) / len(buckets))
            staged_ms = graph_ms(fns["staged"]) / len(buckets)
            row = {"kernel": kernel, "chains": b,
                   "components": [bk.s_cap * 3 for bk in buckets],
                   "parent_ms": min(times["parent"]), "new_ms": min(times["new"]),
                   "turns_ms": times, "staged_ms": staged_ms,
                   "new vs parent max abs": max_abs(got, want),
                   "staged vs whole max abs": max_abs(staged, got)}
            report["shapes"][f"{kernel} B={b}"] = row
            print(f"[turns] {kernel} config 5 B={b}: parent {row['parent_ms']:.6f} -> new "
                  f"{row['new_ms']:.6f} ms a bucket call (turns {times['parent']} / "
                  f"{times['new']}); staged path forced {staged_ms:.6f} ms; max abs new vs "
                  f"parent {row['new vs parent max abs']:.4g}, staged vs whole "
                  f"{row['staged vs whole max abs']:.4g}", flush=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(f"[tiled_turns] card: {card}; wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
