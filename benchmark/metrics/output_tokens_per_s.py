"""Every token the host received in the window, over the window."""


def read(run):
    return run.tokens / run.window_s if run.tokens else None
