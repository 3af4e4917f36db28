"""Every prompt token prefilled in the window (its request's first token
received), over the window."""


def read(run):
    return run.prompt_tokens / run.window_s if run.prompt_tokens else None
