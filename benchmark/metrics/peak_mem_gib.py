"""peak_mem_gib: torch.cuda.max_memory_allocated() over the set-up and the
window (read before the reference runs), in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
