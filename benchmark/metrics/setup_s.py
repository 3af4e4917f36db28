"""Set-up: from the process's start to the window's (imports, the card's
context, the kernels' build where the checkout has none, the weights,
the warm-ups and captures of the bodies, one warm batch)."""


def read(run):
    return run.setup_s
