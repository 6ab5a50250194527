"""``row_store_gb``: the device memory the epoch's rows take, in GB (1e9 B):
the local rows' ids and their offsets and the replicated cache rows, as the
program counts them (``DeviceLCCProblem.row_store_bytes``). Nothing to read
where the program has no such count."""


def read(run):
    count = getattr(getattr(run.state, "dev_prob", None), "row_store_bytes",
                    None)
    return None if count is None else count() / 1e9
