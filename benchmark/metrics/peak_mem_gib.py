"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window, after
the peak was reset at its start, in GiB."""


def read(run: dict):
    return run["peak_bytes"] / 2 ** 30 if run["peak_bytes"] else None
