"""``graph_to_solution_s``: the window's time over the cycles in it; a
cycle runs from handing the service a graph it has not seen to the last
of that graph's solutions."""


def read(run):
    if run.kind != "resparsify" or not run.batches:
        return None
    return run.window_s / len(run.batches)
