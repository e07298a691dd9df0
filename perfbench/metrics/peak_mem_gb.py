"""The device allocator's peak over the whole run
(``torch.cuda.max_memory_allocated``), in 1e9 bytes, read before the
reference runs."""


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None
