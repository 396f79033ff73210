"""GiB: the largest device memory a job allocated above what was held when
it started (``torch.cuda.max_memory_allocated``), over the window's jobs and
the ranks; nothing off the card."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes > 0 else None
