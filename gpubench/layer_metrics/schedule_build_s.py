"""``schedule_build_s``: host seconds of the harness's span around the
program's schedule build (``build_sharded_problem``)."""


def read(run):
    return run.spans.seconds.get("schedule_build")
