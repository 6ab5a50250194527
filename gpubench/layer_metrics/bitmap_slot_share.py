"""``bitmap_slot_share``: of the epoch's real edge slots, the share that the
edge count takes in hub runs against a bitmap of the hub's row rather than
pair by pair, as the program's run table counts them
(``repro_torch.kernels.epoch_count.bitmap_slot_share``). Nothing to read
where the program has no such count."""


def read(run):
    prob = getattr(run.state, "dev_prob", None)
    if prob is None:
        return None
    from repro_torch.kernels import epoch_count

    share = getattr(epoch_count, "bitmap_slot_share", None)
    return None if share is None else share(prob)
