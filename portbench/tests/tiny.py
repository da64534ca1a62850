"""Tiny sizes of every cell, for driving whole runs on the CPU in tests:
``harness.run_cell(cell, seed, seconds, trace, device="cpu",
**TINY[cell])``. Widths and counts are cut; the hyperparameters and the
code paths are the cells' own (on the CPU the solvers take the program's
plain routes), but for DSGD's learning rate: at 0.3 (×2.5 for two sweeps)
the tiny problem's few ratings a row diverge to NaN on some seeds, in the
program and the reference alike."""

_ML = {
    "data": {"num_users": 300, "num_items": 200, "ratings": 8000,
             "train_fraction": 0.95, "planted_rank": 4, "noise": 0.1,
             "skew": 2.0},
    "dsgd": {"num_factors": 8, "lambda_": 0.1, "iterations": 3,
             "learning_rate": 0.05, "lr_schedule": "warm_boost",
             "minibatch_size": 64, "init_scale": 0.08,
             "collision_mode": "mean", "minibatch_sort": "item",
             "factor_dtype": "float32", "num_blocks": 4},
    "als": {"num_factors": 8, "lambda_": 0.1, "iterations": 3,
            "reg_mode": "direct", "init_scale": 0.1, "gram_dtype": None},
    "serve": {"num_factors": 8, "k": 10, "max_batch": 64,
              "dtype": "float32", "torch_threads": 1},
}
_NF = {
    "data": {"num_users": 500, "num_items": 100, "ratings": 20000,
             "planted_rank": 4, "noise": 0.1, "skew": 2.0},
    "online": {"num_factors": 8, "learning_rate": 0.05,
               "minibatch_size": 256, "init_capacity": 64,
               "init_scale": 0.1, "iterations_per_batch": 1,
               "collision_mode": "mean"},
}

TINY = {
    "ml25m_r128.dsgd_fit": {"config_override": _ML},
    "ml25m_r128.als_fit": {"config_override": _ML},
    "netflix_r128.online_stream": {"config_override": _NF,
                                   "mix_override": {"batch": 1000}},
    "ml25m_r128.serve_topk_over": {"config_override": _ML,
                                   "mix_override": {"rate_rps": 20000}},
}


def control(cell: str) -> dict:
    """The cell's control (``limits/<cell>.json``) at the tiny size: the
    same switch of precision on the tiny configuration."""
    import os

    from portbench import harness

    ctl = harness.load_json(os.path.join(
        harness.BENCH_DIR, "limits", cell + ".json"))["control"]
    base = TINY[cell]["config_override"]
    over = dict(base)
    for key, val in ctl.items():
        over[key] = {**base[key], **val} if isinstance(val, dict) else val
    return {**TINY[cell], "config_override": over}
