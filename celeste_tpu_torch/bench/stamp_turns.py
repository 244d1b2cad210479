"""The stamp kernels K1 and K7 (``csrc/mog_field.cu``) and K8
(``csrc/mog_field_sep.cu``) against an earlier version of their sources,
built and timed in turns in one process on one card.

    python -m celeste_tpu_torch.bench.stamp_turns --parent DIR
        [--parent-geometry none|k1|k7|sets|all] [--out FILE]

``DIR`` holds the earlier ``mog_field.cu`` and ``mog_common.cuh`` (for
example ``git show <rev>:celeste_tpu_torch/csrc/mog_field.cu``) and, to
compare K8 too, the earlier ``mog_field_sep.cu``.  ``--parent-geometry``
says which of the parent's entries take their launch geometry (CB, T) as
this tree's do: ``none`` (before K1's cluster launch), ``k1`` (K1 but not
K7: the sources before K7's redesign), ``k7`` (K1 and K7, but no pixel-set
count: the sources before the pixel-set mode), ``sets`` (the pixel-set
count, but no ``staged`` flag and no backward scratch: the sources before
the staged path) or ``all`` (the default: this tree's interface, for a
variant of it).  Against a ``k7`` parent the [1, P] outputs show whether
the stamp's calls kept their bits; against ``sets`` or ``all`` the
field's pixel-set shapes are compared too.  The script

1. builds both sources with the package's nvcc flags plus ``-Xptxas -v``
   and prints each kernel's registers and spills;
2. counts the SASS of every K1, K7 and K8 kernel of both (``cuobjdump
   -sass``): the instructions of each innermost loop (a backward branch and
   its body) by opcode;
3. times K1-fwd and K1-bwd of both at the shapes where the samplers call
   K1, K7 at the PPC's two launch shapes and over config 5's 48x128 field
   at B=1024, K1-fwd, K1-bwd and K7 at the field's pixel-set shapes
   (SET_SHAPES, a parent with the pixel-set count only), and K8-fwd and
   K8-bwd at config 1's stamp (B=4096 and 65536)
   and at B=64 on a 128x128 stamp, in turns (parent, new, new, parent),
   each turn the best of 3 replays of a CUDA graph of 20 calls
   (``bench/timing.py``), so that a few-microsecond kernel is timed on the
   card, not at the host's launch rate; the new kernels' outputs are held
   against the parent's on the way;
4. times the new K7 at every geometry (CB, T) that fits each K7 shape, once
   each, its output bitwise equal to the chosen geometry's.

``--out`` takes the SASS listings and a JSON of the numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from celeste_tpu_torch.bench.timing import graph_ms
from celeste_tpu_torch.kernels import _build
from celeste_tpu_torch.kernels import mog_field as mf

# (name, kind, stamp side, chains): config 1 (star_single, 64 chains),
# config 2 (star_ugriz, 32 chains; each band's call is this shape), config 3
# (galaxy, 32 chains, 31x31), and the star at 4096 and 65536 chains (the
# evals/s shape)
SHAPES = (("config 1", "star", 25, 64), ("config 2", "star", 25, 32),
          ("config 3", "galaxy", 31, 32), ("B=4096", "star", 25, 4096),
          ("B=65536", "star", 25, 65536))


# K8's shapes (stamp side, chains): config 1's 25x25 stamp at 4096 chains and
# at the evals/s chain count, and a 128x128 stamp at 64 chains
K8_SHAPES = ((25, 4096), (25, 65536), (128, 64))

# K7's shapes (name, kind, stamp side, chains): the PPC's 32 draws of config
# 2's star (C=3, 25x25) and config 3's galaxy (C=48, 31x31), and config 5's
# 48x128 field with its dense planes (C=126) at 1024 chains
K7_SHAPES = (("star [32, 640]", "star", 25, 32), ("galaxy [32, 1024]", "galaxy", 31, 32),
             ("config-5 field B=1024", "field", None, 1024))

# the field's pixel-set shapes (name, sets, rows per set, components, cutout
# side): chip_smoke.py's PIXEL_SET_SHAPES, the detection and classify
# cutouts and the groups of field and field_survey
SET_SHAPES = (("cutout R=1", 16, 1, 48, 24), ("cutout R=2", 16, 2, 48, 24),
              ("group 48x48 R=8", 4, 8, 96, 48), ("group 48x48 R=32", 4, 32, 96, 48),
              ("group 32x32 R=8", 53, 8, 144, 32), ("group 32x32 R=32", 4, 32, 144, 32))


def build(src: Path, out: Path) -> str:
    """nvcc the source ``src`` into ``out``; returns ptxas's report."""
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {src}:\n{proc.stdout}{proc.stderr}")
    return proc.stderr


def registers(report: str) -> dict:
    """{kernel: {registers, spill_bytes}} from ptxas's report."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+((?:loglik|render|sep)\w*?_kernel)"
                      r"(?:I((?:L[ib]\d+E)+)E)?", line)
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
            name = m.group(1) + (f"<{', '.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if name and m:
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def sass_loops(lib: Path, listing: Path) -> dict:
    """{kernel: [innermost loops as {opcode: count}]} of the K1 and K8
    kernels, from ``cuobjdump -sass``; the listing is written to
    ``listing``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    listing.write_text(text)
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if not any(k in name for k in ("loglik", "render", "sep_")):
            continue
        instrs = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
                             block):
            instrs.append((int(m.group(1), 16), m.group(2), m.group(3)))
        loops = []
        for addr, op, args in instrs:
            t = re.search(r"0x([0-9a-f]+)", args)
            if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
                lo = int(t.group(1), 16)
                body = [o for a, o, _ in instrs if lo <= a <= addr]
                loops.append((lo, addr, body))
        # innermost: loops that contain no other loop
        inner = [lp for lp in loops
                 if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        out[name] = [dict(Counter(body), total=len(body)) for _, _, body in inner]
    return out


def declare_parent(lib, geometry):
    """Declare the parent's entries: this tree's (``geometry="all"``), or
    without the staged flag and scratch (``"sets"``), also without the
    pixel-set count (``"k7"``), and also without the geometry arguments of
    K7 (``"k1"``) or of K1 and K7 (``"none"``)."""
    mf.LIBRARY.declare(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    if geometry == "all":
        return
    if geometry == "sets":
        lib.mog_field_loglik_fwd.argtypes = [p] * 12 + [i] * 7 + [p]
        lib.mog_field_loglik_bwd.argtypes = [p] * 18 + [i] * 6 + [p]
        lib.mog_field_render.argtypes = [p] * 10 + [i] * 6 + [p]
        return
    lib.mog_field_loglik_fwd.argtypes = [p] * 12 + [i] * (4 if geometry == "none" else 6) + [p]
    lib.mog_field_loglik_bwd.argtypes = [p] * 18 + [i] * (3 if geometry == "none" else 5) + [p]
    lib.mog_field_render.argtypes = [p] * 10 + [i] * (5 if geometry == "k7" else 3) + [p]


def shape_inputs(kind, side, b, device):
    """One-band K1 planes of ``b`` chains scattered around the truth, the
    stamp's pixel arrays, a cotangent g, the chains' vectors and the
    stamp."""
    from celeste_tpu_torch.data.synthetic import galaxy_source, make_synthetic_stamp, star_source

    if kind == "star":
        src = star_source(u=(30.00005, 10.00008), flux_r=30.0)
        extra = []
    else:
        src = galaxy_source(u=(30.0, 10.0), flux_r=60.0)
        t, ab = src["theta_dev"], src["ab"]
        extra = [[np.log(t / (1 - t)), np.log(src["sigma"]), np.log(ab / (1 - ab)), src["phi"]]]
    scene = make_synthetic_stamp([src], shape=(side, side), bands=(2,), seed=0, device=device)
    x0 = np.concatenate([scene.wcs.equa2duas(src["u"]), [np.log(src["flux"][2])], *extra])
    rng = np.random.default_rng(b)
    vecs = torch.as_tensor((x0[None] + 0.01 * rng.normal(size=(b, x0.size))).astype(np.float32),
                           device=device)
    stamp = scene.stamps[0]
    planes = [t.contiguous() for t in mf._field_planes(vecs, stamp, 0, kind, 1)]
    g = torch.as_tensor(rng.normal(size=b).astype(np.float32), device=device)
    return planes, mf.stamp_pixel_data(stamp), g, vecs, stamp


def calls(lib, planes, pixels, g, geometry, sets=True, staged=True):
    """(forward, backward) closures over preallocated outputs; ``geometry``
    is None for the parent's interface without it, ``sets`` False for one
    without the pixel-set count (then one set), ``staged`` False for one
    without the staged flag and the backward's scratch (every shape here
    takes the whole-row path)."""
    b, c = planes[0].shape
    s, p = pixels[0].shape
    out = torch.empty(b, device=g.device)
    grads = [torch.empty(b, c, device=g.device) for _ in range(6)]
    ptrs = [t.data_ptr() for t in (*planes, *pixels)]
    extra = (list(geometry) if geometry else []) + ([0] if staged else [])
    n_sets = [s] if sets else []
    scratch = [None] if staged else []

    def fwd():
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mog_field_loglik_fwd(*ptrs, out.data_ptr(), b, c, p, *n_sets, 0, *extra,
                                       stream)
        assert err == 0, err
        return out

    def bwd():
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mog_field_loglik_bwd(*ptrs, g.data_ptr(), *(t.data_ptr() for t in grads),
                                       *scratch, b, c, p, *n_sets, *extra, stream)
        assert err == 0, err
        return grads

    return fwd, bwd


def render_call(lib, planes, pixels, geometry, sets=True, staged=True):
    """A K7 closure over a preallocated output; ``geometry`` (CB, T), or
    None for a parent's interface without it (and without the pixel-set
    count); ``sets`` False for one without the count, ``staged`` False for
    one without the staged flag."""
    b, c = planes[0].shape
    px, py, _, sky, _ = pixels
    s, p = px.shape
    out = torch.empty(b, p, device=px.device)
    ptrs = [t.data_ptr() for t in (*planes, px, py, sky)]
    extra = (([s] if sets else []) + (list(geometry) if geometry else [])
             + ([0] if staged else []))

    def fn():
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mog_field_render(*ptrs, out.data_ptr(), b, c, p, *extra, stream)
        assert err == 0, err
        return out

    return fn


def k7_inputs(kind, side, b, device):
    """K7's planes and pixel data at one of K7_SHAPES: one-band planes of
    ``b`` chains around a stamp's truth, or config 5's dense planes."""
    if kind != "field":
        planes, pixels, _, _, _ = shape_inputs(kind, side, b, device)
        return planes, pixels
    from celeste_tpu_torch.bench.config5 import build_config5
    from celeste_tpu_torch.parallel.crowded import scene_field_planes

    _, _, vec, info = build_config5(device=device)
    rng = np.random.default_rng(b)
    vecs = vec[None] + torch.as_tensor(0.01 * rng.normal(size=(b, vec.shape[0])),
                                       dtype=torch.float32, device=device)
    planes = [p.contiguous() for p in scene_field_planes(info["scene"], vecs, info["stamp"], 0)]
    return planes, mf.stamp_pixel_data(info["stamp"])


def k7_turns(report, libs, parent_geometry, device):
    """K7 at K7_SHAPES in turns with the parent, then the new kernel at
    every geometry that fits each shape."""
    for name, kind, side, b in K7_SHAPES:
        planes, pixels = k7_inputs(kind, side, b, device)
        p = pixels[0].shape[1]
        chosen = mf.k7_geometry(b, p)
        fns = {"parent": render_call(libs["parent"], planes, pixels,
                                     chosen if parent_geometry in ("k7", "sets", "all") else None,
                                     sets=parent_geometry in ("sets", "all"),
                                     staged=parent_geometry == "all"),
               "new": render_call(libs["new"], planes, pixels, chosen)}
        want = fns["parent"]().clone()
        got = fns["new"]().clone()
        plain = mf._render_torch(*planes, pixels[0], pixels[1], pixels[3])
        torch.cuda.synchronize()
        times = {"parent": [], "new": []}
        for tag in ("parent", "new", "new", "parent"):
            times[tag].append(graph_ms(fns[tag]))
        sweep = {}
        for cb in (1, 2, 4, 8):
            for t in (1, 2, 4, 8, 16, 32):
                if t > -(-p // 32):
                    continue
                fn = render_call(libs["new"], planes, pixels, (cb, t))
                ms = graph_ms(fn)
                if not torch.equal(fn(), got):
                    raise RuntimeError(f"K7 {name}: geometry {(cb, t)} differs from {chosen}")
                sweep[f"{cb},{t}"] = ms
        row = {"kernel": "K7", "chains": b, "n_comp": planes[0].shape[1], "n_pix": p,
               "geometry (CB, T)": chosen, "parent_ms": min(times["parent"]),
               "new_ms": min(times["new"]), "turns_ms": times,
               "new vs parent max abs": float((got - want).abs().max()),
               "new vs plain max abs": float((got - plain).abs().max()),
               "parent vs plain max abs": float((want - plain).abs().max()),
               "new by geometry (CB,T) ms": sweep}
        report["shapes"][f"K7 {name}"] = row
        best = min(sweep, key=sweep.get)
        print(f"[turns] K7 {name}: B={b} C={row['n_comp']} P={p} (CB, T)={chosen}: parent "
              f"{row['parent_ms']:.6f} -> new {row['new_ms']:.6f} ms (turns {times['parent']} / "
              f"{times['new']}); max abs vs parent {row['new vs parent max abs']:.4g}, vs plain "
              f"{row['new vs plain max abs']:.4g} (parent vs plain "
              f"{row['parent vs plain max abs']:.4g}); fastest geometry {best}: "
              f"{sweep[best]:.6f} ms; sweep {sweep}", flush=True)


def set_turns(report, libs, parent_geometry, device):
    """K1-fwd, K1-bwd and K7 at the field's pixel-set shapes (SET_SHAPES,
    ``mog_field.random_pixel_set_problem``) in turns with the parent."""
    for name, n_sets, r, c, side in SET_SHAPES:
        planes, sets = mf.random_pixel_set_problem(n_sets, r, c, side, seed=n_sets * r)
        planes = [torch.as_tensor(a, device=device) for a in planes]
        sets = [torch.as_tensor(a, device=device) for a in sets]
        b, p = n_sets * r, sets[0].shape[1]
        g = torch.as_tensor(np.random.default_rng(b).normal(size=b).astype(np.float32),
                            device=device)
        k1 = mf.k1_geometry(b, p, n_sets)
        fns = {"parent": calls(libs["parent"], planes, sets, g, k1,
                               staged=parent_geometry == "all"),
               "new": calls(libs["new"], planes, sets, g, k1)}
        row = {"kernel": "K1", "sets": n_sets, "chains": b, "n_comp": c, "n_pix": p,
               "geometry (CB, T)": k1}
        report_row(report, f"sets {name}", f"K1 sets {name} B={b} C={c} S={n_sets} (CB, T)={k1}",
                   row, *in_turns(fns))
        k7 = mf.k7_geometry(b, p, n_sets)
        fns = {"parent": render_call(libs["parent"], planes, sets, k7,
                                     staged=parent_geometry == "all"),
               "new": render_call(libs["new"], planes, sets, k7)}
        want, got = fns["parent"]().clone(), fns["new"]().clone()
        times = {"parent": [], "new": []}
        for tag in ("parent", "new", "new", "parent"):
            times[tag].append(graph_ms(fns[tag]))
        row = {"kernel": "K7", "sets": n_sets, "chains": b, "n_comp": c, "n_pix": p,
               "geometry (CB, T)": k7, "parent_ms": min(times["parent"]),
               "new_ms": min(times["new"]), "turns_ms": times,
               "new vs parent max abs": float((got - want).abs().max())}
        report["shapes"][f"K7 sets {name}"] = row
        print(f"[turns] K7 sets {name}: B={b} C={c} S={n_sets} P={p} (CB, T)={k7}: parent "
              f"{row['parent_ms']:.6f} -> new {row['new_ms']:.6f} ms (turns {times['parent']} / "
              f"{times['new']}); max abs vs parent {row['new vs parent max abs']:.4g}",
              flush=True)


def sep_calls(lib, planes, pixels, g):
    """K8's (forward, backward) closures over preallocated outputs."""
    b, c = planes[0].shape
    h, w = pixels[2].shape
    out = torch.empty(b, device=g.device)
    grads = [torch.empty(b, c, device=g.device) for _ in range(4)]
    ptrs = [t.data_ptr() for t in (*planes, *pixels)]

    def fwd():
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mog_field_sep_fwd(*ptrs, out.data_ptr(), b, c, h, w, 0, stream)
        assert err == 0, err
        return out

    def bwd():
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mog_field_sep_bwd(*ptrs, g.data_ptr(), *(t.data_ptr() for t in grads),
                                    b, c, h, w, stream)
        assert err == 0, err
        return grads

    return fwd, bwd


def in_turns(fns):
    """Outputs of new against parent, then each kernel timed in turns
    (parent, new, new, parent): ({fwd, bwd: difference}, {(tag, kernel):
    [ms per turn]})."""
    want_f, want_b = fns["parent"][0]().clone(), [t.clone() for t in fns["parent"][1]()]
    got_f, got_b = fns["new"][0]().clone(), fns["new"][1]()
    torch.cuda.synchronize()
    diff = {"fwd": float((got_f - want_f).abs().max()),
            "bwd": max(float((a - w).abs().max() / (w.abs().max() + 1e-30))
                       for a, w in zip(got_b, want_b))}
    times = {(tag, k): [] for tag in fns for k in ("fwd", "bwd")}
    for tag in ("parent", "new", "new", "parent"):
        for k, fn in zip(("fwd", "bwd"), fns[tag]):
            times[(tag, k)].append(graph_ms(fn))
    return diff, times


def report_row(report, name, what, row, diff, times):
    for (tag, k), ts in times.items():
        row[f"{k}_{tag}_ms"] = min(ts)
        row[f"{k}_{tag}_turns_ms"] = ts
    row["new vs parent"] = diff
    report["shapes"][name] = row
    print(f"[turns] {name}: {what}: "
          f"fwd parent {row['fwd_parent_ms']:.6f} -> new {row['fwd_new_ms']:.6f} ms "
          f"(turns {times[('parent', 'fwd')]} / {times[('new', 'fwd')]}); "
          f"bwd parent {row['bwd_parent_ms']:.6f} -> new {row['bwd_new_ms']:.6f} ms "
          f"(turns {times[('parent', 'bwd')]} / {times[('new', 'bwd')]}); "
          f"new vs parent: fwd max abs {diff['fwd']:.4g}, bwd max rel {diff['bwd']:.4g}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--parent-geometry", choices=("none", "k1", "k7", "sets", "all"),
                    default="all",
                    help="which of the parent's entries take (CB, T) as this tree's do: none, "
                         "K1 only (the sources before K7's redesign), K1 and K7 with no "
                         "pixel-set count (before the pixel-set mode), K1 and K7 with the "
                         "count but no staged flag (before the staged path), or all (a "
                         "variant of this tree)")
    ap.add_argument("--out", type=Path,
                    default=_build.BUILD_DIR / "stamp_turns" / "stamp_turns.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stamp_turns: CUDA is not available")
    device = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    work = _build.BUILD_DIR / "stamp_turns"
    work.mkdir(parents=True, exist_ok=True)
    libs, report = {}, {"card": card, "registers": {}, "sass_inner_loops": {}, "shapes": {}}
    for tag, src in (("parent", args.parent), ("new", _build.CSRC_DIR)):
        so = work / f"{tag}.so"
        report["registers"][tag] = registers(build(src / "mog_field.cu", so))
        report["sass_inner_loops"][tag] = sass_loops(so, args.out.with_name(f"sass_{tag}.txt"))
        libs[tag] = ctypes.CDLL(str(so))
    declare_parent(libs["parent"], args.parent_geometry)
    mf.LIBRARY.declare(libs["new"])
    print(f"[stamp_turns] card: {card}", flush=True)
    print(json.dumps({"registers": report["registers"]}), flush=True)
    for tag, kernels in report["sass_inner_loops"].items():
        for name, loops in kernels.items():
            print(f"[sass] {tag} {name}: inner loops {loops}", flush=True)

    for name, kind, side, b in SHAPES:
        planes, pixels, g, _, _ = shape_inputs(kind, side, b, device)
        geometry = mf.k1_geometry(b, pixels[0].shape[1])
        fns = {"parent": calls(libs["parent"], planes, pixels, g,
                               None if args.parent_geometry == "none" else geometry,
                               sets=args.parent_geometry in ("sets", "all"),
                               staged=args.parent_geometry == "all"),
               "new": calls(libs["new"], planes, pixels, g, geometry)}
        row = {"kernel": "K1", "kind": kind, "stamp": f"{side}x{side}", "chains": b,
               "n_comp": planes[0].shape[1], "n_pix": pixels[0].shape[1],
               "geometry (CB, T)": geometry}
        report_row(report, name, f"K1 {kind} {side}x{side} B={b} (CB, T)={geometry}", row,
                   *in_turns(fns))
    k7_turns(report, libs, args.parent_geometry, device)
    if args.parent_geometry in ("sets", "all"):
        set_turns(report, libs, args.parent_geometry, device)

    if (args.parent / "mog_field_sep.cu").exists():
        from celeste_tpu_torch.kernels import mog_field_sep as ms

        sep = {}
        for tag, src in (("parent", args.parent), ("new", _build.CSRC_DIR)):
            so = work / f"sep_{tag}.so"
            report["registers"][f"K8 {tag}"] = registers(build(src / "mog_field_sep.cu", so))
            report["sass_inner_loops"][f"K8 {tag}"] = sass_loops(
                so, args.out.with_name(f"sass_sep_{tag}.txt"))
            sep[tag] = ctypes.CDLL(str(so))
            ms.LIBRARY.declare(sep[tag])
        print(json.dumps({"K8 registers": {t: report["registers"][f"K8 {t}"] for t in sep}}),
              flush=True)
        for tag in sep:
            for name, loops in report["sass_inner_loops"][f"K8 {tag}"].items():
                print(f"[sass] K8 {tag} {name}: inner loops {loops}", flush=True)
        for side, b in K8_SHAPES:
            _, _, g, vecs, stamp = shape_inputs("star", side, b, device)
            sp = [t.contiguous() for t in ms.star_planes_isotropic(vecs, stamp, 0, 1)]
            pix = ms.stamp_pixel_data_2d(stamp)
            fns = {tag: sep_calls(lib, sp, pix, g) for tag, lib in sep.items()}
            stamp_name = f"{side}x{side}"
            report_row(report, f"K8 {stamp_name} B={b}", f"K8 star {stamp_name} B={b}",
                       {"kernel": "K8", "chains": b, "stamp": stamp_name}, *in_turns(fns))
    args.out.write_text(json.dumps(report, indent=1))
    print(f"[stamp_turns] card: {card}; wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
