"""``peak_mem_gb``: ``torch.cuda.max_memory_allocated`` over set-up and the
window, in units of 1e9 bytes; None off the card."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 1e9
