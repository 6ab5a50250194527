"""``heavy_slot_share``: of the epoch's real edge slots, the share that the
edge count's tile blocks count as heavy pairs, each by a whole block (more
compares than the tile's heavy threshold, no bitmap piece over them), as the
program counts them (``repro_torch.kernels.epoch_count.heavy_slot_share``).
Nothing to read where the program has no such count."""


def read(run):
    prob = getattr(run.state, "dev_prob", None)
    if prob is None:
        return None
    from repro_torch.kernels import epoch_count

    share = getattr(epoch_count, "heavy_slot_share", None)
    return None if share is None else share(prob)
