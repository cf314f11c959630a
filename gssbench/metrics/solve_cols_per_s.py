"""``solve_cols_per_s``: right-hand-side columns solved to their tolerance
(by the program's own report) over the window's flush time."""


def read(run):
    if run.kind != "closed_batch" or run.window_s <= 0:
        return None
    return sum(b.solved for b in run.batches) / run.window_s
