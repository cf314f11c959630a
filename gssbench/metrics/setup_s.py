"""``setup_s``: seconds from the harness's first line to the first timed
operation (graph, service, hierarchy where the cell builds it in set-up,
warm-ups)."""


def read(run):
    return run.setup_s
