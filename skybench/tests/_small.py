"""The small runs the CPU tests drive.  ``SMALL``: a cell's configuration
and traffic at 16 chains with its set-up cut in steps (the field, the
sources and the widths as the cell has them).  ``tiny(cell)``: two blended
stars of the cell's scene on a 16 x 128 frame, by default at 256 chains
and a window of 100 steps, where the window's draws are enough for the
reference's moments to judge them."""

from skybench import catalog

SMALL = {
    "traffic": {"chains": 16, "adapt_iters": 3, "adapt_window": 3, "max_leapfrog": 6,
                "segment_steps": 6, "check_rows": 4, "moment_samples": 256},
    "prep": {"n_warmup": 6, "warmup_window": 6, "warmup_leapfrog": 3, "probe_steps": 4,
             "probe_max_depth": 3, "n_zwarm": 3, "zwarm_leapfrog": 3},
}


def tiny(cell: str, chains: int = 256, steps: int = 100) -> dict:
    entry = next(w for w in catalog.benchmark()["workloads"] if w["name"] == cell)
    cfg = catalog.load_json("configs", entry["config"])
    pair = [dict(s) for s in cfg["sources"] if s["kind"] == "star"][:2]
    for s, (x, y) in zip(pair, [(61.5, 7.2), (64.0, 8.1)]):
        s.update(x_px=x, y_px=y)
    return {"config": {"field": dict(cfg["field"], shape=[16, 128]), "sources": pair},
            "traffic": {"chains": chains, "max_leapfrog": 5, "segment_steps": steps,
                        "check_rows": 16, "moment_samples": 16384},
            "prep": {"n_warmup": 30, "warmup_window": 30, "warmup_leapfrog": 4,
                     "probe_max_depth": 4, "zwarm_leapfrog": 4}}
