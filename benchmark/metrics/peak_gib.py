"""peak_gib: torch.cuda.max_memory_allocated() over the whole run, set-up
included, read when the window closes."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30
