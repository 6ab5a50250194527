"""``cached_slot_share``: of the schedule's real edge slots whose ``v`` row
another rank owns, the share the replicated degree cache serves rather than
the pull exchange, as the program counts them
(``ShardedLCCProblem.slot_counts``: ``cached / (cached + pulled)``). The
program owns the row-index layout the count reads, so the count follows it.
Nothing to read where the program has no such count."""


def read(run):
    slot_counts = getattr(getattr(run.state, "host_prob", None),
                          "slot_counts", None)
    if slot_counts is None:
        return None
    c = slot_counts()
    remote = c["cached"] + c["pulled"]
    return c["cached"] / remote if remote else None
